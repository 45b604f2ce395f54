from .hash_soa import HashGridEncoderFused, HashGridEncoderGrouped, grid_resolutions
from .mlp import MLP, NDRTNeRFRadianceField, NerfMLP, SinusoidalEncoder, TNeRFRadianceField, VanillaNeRFRadianceField
from .ngp import NGPDensityField, NGPRadianceField, contract_tanh, contract_tanh_inv

__all__ = [
    "HashGridEncoderFused",
    "HashGridEncoderGrouped",
    "MLP",
    "NDRTNeRFRadianceField",
    "NGPDensityField",
    "NGPRadianceField",
    "NerfMLP",
    "SinusoidalEncoder",
    "TNeRFRadianceField",
    "VanillaNeRFRadianceField",
    "contract_tanh",
    "contract_tanh_inv",
    "grid_resolutions",
]
