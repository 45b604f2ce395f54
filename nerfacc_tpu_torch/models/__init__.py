from .hash_soa import HashGridEncoderFused, grid_resolutions
from .ngp import NGPRadianceField

__all__ = ["HashGridEncoderFused", "NGPRadianceField", "grid_resolutions"]
