"""The in-process core runtime (counterpart of ``ray_tpu/core``): tasks,
actors, objects held by reference, placement groups, the GCS registries
and the task event buffer, with tasks and actors as threads of the
process that owns the card. ``ray_tpu_torch.init/remote/get/put/...``
re-export ``core.api``. ``init(worker_mode="process")`` runs tasks in
worker processes (``core/process_pool.py``), and ``init(address=...)``
attaches the driver to a cluster (``core/cluster_backend.py`` over
``ray_tpu_torch.cluster``)."""
