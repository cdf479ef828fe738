"""Core runtime pieces the serving planes need in one process (counterpart of
part of ``ray_tpu/core``): the in-process object store. Tasks, actors and
the store shared across processes wait for the cluster runtime (ROADMAP.md
Queue 1, B8)."""
