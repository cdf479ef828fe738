"""Training (counterpart of ``ray_tpu/train``): the train step."""

from ray_tpu_torch.train.step import TrainState, adamw, make_train_step

__all__ = ["TrainState", "adamw", "make_train_step"]
