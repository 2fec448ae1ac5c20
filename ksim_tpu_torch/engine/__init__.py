"""Scheduling engine: the plugin chain, the sequential-commit scan and
batch evaluation, on the card through kernels/ or on the CPU."""
