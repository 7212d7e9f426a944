"""PyTorch + CUDA port of the CMoE system (`repro`), for NVIDIA Hopper.

The JAX package `repro` stays the reference; this package keeps its module
names so each counterpart is easy to find, and imports nothing of it.
Entry points run on ``cuda`` unless the caller asks for the CPU.
"""
