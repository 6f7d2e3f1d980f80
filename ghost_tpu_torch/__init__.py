"""PyTorch/CUDA port of ghost_tpu for one NVIDIA H100.

Module paths and names mirror `ghost_tpu` one for one
(`ghost_tpu/models/aei.py` <-> `ghost_tpu_torch/models/aei.py`). Public
functions keep the JAX layouts (NHWC images, (B,T,2,3) matrices,
(B,106,2) landmarks); the conv nets run NCHW tensors in
`torch.channels_last` memory inside. The package imports torch and
numpy (and msgpack, to read flax checkpoints), never jax or ghost_tpu.
"""
