"""The port's command-line programs, each run as
``python -m nerfacc_tpu_torch.examples.<name>``: ``train_ngp_nerf_occ``,
``train_ngp_nerf_prop``, ``render``, ``train_mlp_nerf`` and
``train_mlp_tnerf``."""
