"""Path generators: MRW, PDV; scattering spectra in :mod:`.scattering`."""
from shadowing_tpu_torch.models.mrw import MRWGenerator
from shadowing_tpu_torch.models.pdv import (
    DEFAULT1,
    DEFAULT2,
    AutoregressiveLinearPredictor,
    PDVModel,
    PDVModelDiscrete,
    compute_factor,
    future_pdv_model,
    kernel_exp,
    kernel_pl,
)
