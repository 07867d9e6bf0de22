"""Torch ops of the port: dense min-plus SPF and sliced-ELL SPF (mirrors ``openr_tpu/ops/``)."""
