"""Scenario replay: timed operation streams driving the simulator (the
port of ``ksim_tpu/scenario``: the runner and the churn generator)."""
