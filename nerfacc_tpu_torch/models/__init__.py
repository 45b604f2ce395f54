from .encoding import HashGridEncoder, spherical_harmonics_deg4
from .hash_soa import (
    HashGridEncoderFolded,
    HashGridEncoderFused,
    HashGridEncoderGrouped,
    HashGridEncoderSoA,
    grid_resolutions,
    paired_safe_level_count,
)
from .mlp import MLP, NDRTNeRFRadianceField, NerfMLP, SinusoidalEncoder, TNeRFRadianceField, VanillaNeRFRadianceField
from .ngp import NGPDensityField, NGPRadianceField, contract_tanh, contract_tanh_inv, contract_to_unisphere, trunc_exp
from .tensorf import KPlanesRadianceField, TensoRFRadianceField
from .tineuvox import TiNeuVoxRadianceField

__all__ = [
    "HashGridEncoder",
    "HashGridEncoderFolded",
    "HashGridEncoderFused",
    "HashGridEncoderGrouped",
    "HashGridEncoderSoA",
    "KPlanesRadianceField",
    "MLP",
    "NDRTNeRFRadianceField",
    "NGPDensityField",
    "NGPRadianceField",
    "NerfMLP",
    "SinusoidalEncoder",
    "TNeRFRadianceField",
    "TensoRFRadianceField",
    "TiNeuVoxRadianceField",
    "VanillaNeRFRadianceField",
    "contract_tanh",
    "contract_tanh_inv",
    "contract_to_unisphere",
    "grid_resolutions",
    "paired_safe_level_count",
    "spherical_harmonics_deg4",
    "trunc_exp",
]
