"""PyTorch/CUDA port of ``openr_tpu``: one node's Decision route build.

The port runs on an NVIDIA card. Every entry point takes ``device=None``,
which means ``torch.device("cuda")``; without CUDA it raises unless the
caller passes ``device="cpu"``. The JAX package ``openr_tpu`` is the
reference the port is held against; the port imports nothing of it.
"""
