from .hash_soa import HashGridEncoderFused, HashGridEncoderGrouped, grid_resolutions
from .ngp import NGPDensityField, NGPRadianceField, contract_tanh, contract_tanh_inv

__all__ = [
    "HashGridEncoderFused",
    "HashGridEncoderGrouped",
    "NGPDensityField",
    "NGPRadianceField",
    "contract_tanh",
    "contract_tanh_inv",
    "grid_resolutions",
]
