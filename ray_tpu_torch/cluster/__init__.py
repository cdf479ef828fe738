"""Control-plane pieces the serving planes need in one process (counterpart
of part of ``ray_tpu/cluster``): the KV prefix index table. The GCS, its
RPCs and the node runtime wait for the cluster runtime (ROADMAP.md Queue 1,
B8)."""
