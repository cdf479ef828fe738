"""Native host components (counterpart of ``ray_tpu/native``): the
shared-memory object store under process workers (``shm.py``, C++ in
``src/``), built with ``g++`` at first use into ``_build/``."""
