"""Simulator configuration: env vars over config.yaml over defaults.

Mirrors the reference's SimulatorConfiguration v1alpha1 layering
(reference simulator/config/config.go:60-114, config/v1alpha1/types.go:
23-75): every env var overrides the corresponding config.yaml field; the
KubeSchedulerConfiguration loads from ``kubeSchedulerConfigPath``.  Fields
tied to the reference's KWOK topology (etcdURL, kubeApiServerUrl) have no
meaning over the in-memory store; they are accepted and ignored so a
reference config.yaml parses.  The external-cluster handle here is a
snapshot source: ``externalSnapshotPath`` points at a reference-format
snapshot JSON (the analogue of kubeConfig for import/sync).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

from ksim_tpu_torch.errors import InvalidConfigError
from ksim_tpu_torch.state.resources import JSON

DEFAULT_CONFIG_PATH = "./config.yaml"
DEFAULT_PORT = 1212


@dataclass
class SimulatorConfig:
    host: str = "127.0.0.1"  # bind address; 0.0.0.0 for containers
    port: int = DEFAULT_PORT
    cors_allowed_origin_list: tuple[str, ...] = ()
    kube_scheduler_config_path: str = ""
    external_import_enabled: bool = False
    resource_sync_enabled: bool = False
    external_snapshot_path: str = ""
    kube_config: str = ""  # live-cluster source (reference config.go:88-114)
    resource_import_label_selector: JSON | None = None
    initial_scheduler_cfg: JSON = field(default_factory=dict)


def _env_bool(name: str, fallback: bool) -> bool:
    v = os.environ.get(name, "")
    if not v:
        return fallback
    return v.lower() in ("1", "true", "yes", "on")


def load_config(path: str | None = None) -> SimulatorConfig:
    """config.yaml (if present) + env overrides (reference getPort et al:
    PORT, CORS_ALLOWED_ORIGIN_LIST, KUBE_SCHEDULER_CONFIG_PATH,
    EXTERNAL_IMPORT_ENABLED, RESOURCE_SYNC_ENABLED, EXTERNAL_SNAPSHOT_PATH)."""
    import yaml

    raw: dict[str, Any] = {}
    cfg_path = path or DEFAULT_CONFIG_PATH
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = yaml.safe_load(f) or {}
    elif path:  # explicitly named file must exist
        raise InvalidConfigError(f"config file {path!r} not found")

    port_raw = os.environ.get("PORT")
    if port_raw is None:
        port_raw = raw.get("port")
    try:
        port = DEFAULT_PORT if port_raw in (None, "") else int(port_raw)
    except (TypeError, ValueError):
        raise InvalidConfigError(f"invalid PORT {port_raw!r}") from None
    # Namespaced env var: plain HOST is ambient in csh/CI images.
    host = os.environ.get("KSIM_HOST") or raw.get("host") or "127.0.0.1"
    cors_env = os.environ.get("CORS_ALLOWED_ORIGIN_LIST", "")
    cors = (
        tuple(x for x in cors_env.split(",") if x)
        if cors_env
        else tuple(raw.get("corsAllowedOriginList") or ())
    )
    sched_path = os.environ.get("KUBE_SCHEDULER_CONFIG_PATH") or raw.get(
        "kubeSchedulerConfigPath", ""
    )
    ext_import = _env_bool(
        "EXTERNAL_IMPORT_ENABLED", bool(raw.get("externalImportEnabled"))
    )
    sync = _env_bool("RESOURCE_SYNC_ENABLED", bool(raw.get("resourceSyncEnabled")))
    snap_path = os.environ.get("EXTERNAL_SNAPSHOT_PATH") or raw.get(
        "externalSnapshotPath", ""
    )
    # Explicit sources first (env alias, then yaml).  The reference's
    # KUBECONFIG (docs/environment-variables.md) is honored as a FALLBACK
    # only when an import feature is ON and no source is configured: the
    # ubiquitous kubectl variable must neither leak into unrelated runs
    # nor conflict with an explicitly configured snapshot path.  kubectl
    # allows an os.pathsep-separated list; the first existing entry wins
    # (full kubeconfig merging is out of scope).
    kube_config = os.environ.get("KUBE_CONFIG") or raw.get("kubeConfig", "")
    if (ext_import or sync) and not kube_config and not snap_path:
        ambient = os.environ.get("KUBECONFIG") or ""
        entries = [p for p in ambient.split(os.pathsep) if p]
        existing = [p for p in entries if os.path.exists(p)]
        kube_config = (existing or entries[:1] or [""])[0]
    if ext_import and sync:
        # Reference: mutually exclusive (config.go:88-90).
        raise InvalidConfigError(
            "externalImportEnabled and resourceSyncEnabled cannot be used "
            "simultaneously"
        )
    if (ext_import or sync) and not (snap_path or kube_config):
        raise InvalidConfigError(
            "externalSnapshotPath or kubeConfig must be set when external "
            "import or resource sync is enabled"
        )
    if (ext_import or sync) and snap_path and kube_config:
        raise InvalidConfigError(
            "externalSnapshotPath and kubeConfig are mutually exclusive "
            "import sources"
        )

    sched_cfg: JSON = {}
    if sched_path:
        with open(sched_path) as f:
            sched_cfg = yaml.safe_load(f) or {}

    return SimulatorConfig(
        host=host,
        port=port,
        cors_allowed_origin_list=cors,
        kube_scheduler_config_path=sched_path,
        external_import_enabled=ext_import,
        resource_sync_enabled=sync,
        external_snapshot_path=snap_path,
        kube_config=kube_config,
        resource_import_label_selector=raw.get("resourceImportLabelSelector"),
        initial_scheduler_cfg=sched_cfg,
    )
