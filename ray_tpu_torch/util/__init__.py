"""Host-side utilities (counterpart of ``ray_tpu/util``)."""
