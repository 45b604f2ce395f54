from .hash_soa import HashGridEncoderFused, HashGridEncoderGrouped, grid_resolutions
from .ngp import NGPRadianceField

__all__ = ["HashGridEncoderFused", "HashGridEncoderGrouped", "NGPRadianceField", "grid_resolutions"]
