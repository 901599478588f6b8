from ventjax_torch.models.segmentation import (
    SegUNet,
    TrainState,
    create_train_state,
    train_step,
    predict_mask,
    save_checkpoint,
    load_checkpoint,
)

__all__ = [
    "SegUNet",
    "TrainState",
    "create_train_state",
    "train_step",
    "predict_mask",
    "save_checkpoint",
    "load_checkpoint",
]
