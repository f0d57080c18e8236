from overlapnet_torch.models.heads import CorrelationHead, DeltaConv1OverlapHead
from overlapnet_torch.models.legs import SiameseLegs, leg_output_width
from overlapnet_torch.models.siamese import (
    OverlapNet,
    build_model,
    init_params,
    reset_parameters,
)

__all__ = [
    "CorrelationHead",
    "DeltaConv1OverlapHead",
    "OverlapNet",
    "SiameseLegs",
    "build_model",
    "init_params",
    "leg_output_width",
    "reset_parameters",
]
