"""Control-plane pieces the serving planes need (counterpart of part of
``ray_tpu/cluster``): the KV prefix index table and the length-prefixed
frame RPC (``rpc.py``: server, pipelined client, client pool) under the
RPC KV connector and the RPC fetch plane. The GCS, its RPCs and the node
runtime wait for the cluster runtime (ROADMAP.md Queue 1, B8)."""
