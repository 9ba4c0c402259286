from .aux_path import AuxPath, init_memory_bank, memory_update
from .pacing import PacingPseudoModel
from .unet import UNet
