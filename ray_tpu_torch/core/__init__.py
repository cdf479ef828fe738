"""The in-process core runtime (counterpart of ``ray_tpu/core``): tasks,
actors, objects held by reference, placement groups, the GCS registries
and the task event buffer, with tasks and actors as threads of the
process that owns the card. ``ray_tpu_torch.init/remote/get/put/...``
re-export ``core.api``. Worker processes and the cluster runtime wait for
ROADMAP.md Queue 1, item 6 (a later part)."""
