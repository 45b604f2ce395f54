"""The plain reference: Instant-NGP, its occupancy grid and proposal
sampling, volume rendering and Adam, in plain PyTorch operations.

Nothing here imports the program under test (``nerfacc_tpu_torch``) or
JAX.  The reference follows the published Instant-NGP and nerfacc
algorithms at the widths and rules the configuration files state; where it
spells out a rule that the measured program has made its own (the tcnn
level resolutions floored in float64, the int32 dense-level test, the
macro-segment budget of the traversal, the fixed sample capacity), the
configuration names the rule and the module docstring says so.  It runs
with TF32 off.
"""
