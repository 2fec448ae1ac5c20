"""The scheduler service over a ClusterStore, on the port's Engine
(the port of ``ksim_tpu/scheduler``, its webhook extenders included)."""
