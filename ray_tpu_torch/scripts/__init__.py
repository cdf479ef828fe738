"""Operator tools: the CLI (``cli.py``), Kubernetes manifests (``k8s.py``)
and the one-query cluster status (``status.py``); counterpart of
``ray_tpu/scripts`` and of the repo's ``scripts/ray_tpu_status.py``."""
