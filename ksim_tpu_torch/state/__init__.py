"""Cluster snapshot -> fixed-shape numpy tensors (host side).

Copies of ``ksim_tpu/state`` modules with imports renamed; the port keeps
its own copies so that it never imports the JAX package."""
