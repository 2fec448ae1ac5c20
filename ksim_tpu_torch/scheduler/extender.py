"""Extender webhook proxy + result store.

Mirrors the reference's extender layer (reference
simulator/scheduler/extender/extender.go:100-199, service.go:18-109,
resultstore/resultstore.go:15-198):

- ``HTTPExtender`` POSTs kube-scheduler extender-v1 payloads to the
  user's webhook (urlPrefix + verb) and re-scales prioritize scores by
  ``weight * MaxNodeScore / MaxExtenderPriority`` (extender.go:142-147);
- ``ExtenderService`` dispatches by extender index, recording every
  request/response pair in the result store — the 4 extender annotations
  ``extender-{filter,prioritize,preempt,bind}-result`` hold
  ``{extenderURL: result}`` maps per verb;
- ``override_extenders_cfg_to_simulator`` rewrites an extender config so
  an EXTERNAL scheduler calls the simulator proxy routes
  (``/api/v1/extender/<verb>/<id>``, service.go:88-109); the in-process
  scheduler service calls ``ExtenderService`` directly.

Extender calls are host-side HTTP, deliberately OUTSIDE the kernels:
when a profile has extenders the scheduler service drops to per-pod
evaluation for exact upstream semantics (filter intersects the feasible
set, prioritize adds to the summed final scores before selectHost).

The port of ``ksim_tpu/scheduler/extender.py``, copied with its imports
renamed (it is plain Python over ``urllib``); each pod's evaluation
between the webhooks is kernel B on the card (scheduler/service.py
``_schedule_queue_with_extenders``).
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
from typing import Sequence

from ksim_tpu_torch.state.resources import JSON, name_of, namespace_of

logger = logging.getLogger(__name__)

PREFIX = "kube-scheduler-simulator.sigs.k8s.io/"
EXTENDER_FILTER_RESULT_KEY = PREFIX + "extender-filter-result"
EXTENDER_PRIORITIZE_RESULT_KEY = PREFIX + "extender-prioritize-result"
EXTENDER_PREEMPT_RESULT_KEY = PREFIX + "extender-preempt-result"
EXTENDER_BIND_RESULT_KEY = PREFIX + "extender-bind-result"

MAX_EXTENDER_PRIORITY = 10  # extenderv1.MaxExtenderPriority
MAX_NODE_SCORE = 100


class ExtenderError(Exception):
    pass


class HTTPExtender:
    """One configured webhook extender (KubeSchedulerConfiguration
    ``extenders[i]``)."""

    def __init__(self, cfg: JSON) -> None:
        self.url_prefix = (cfg.get("urlPrefix") or "").rstrip("/")
        self.filter_verb = cfg.get("filterVerb") or ""
        self.prioritize_verb = cfg.get("prioritizeVerb") or ""
        self.preempt_verb = cfg.get("preemptVerb") or ""
        self.bind_verb = cfg.get("bindVerb") or ""
        self.weight = int(cfg.get("weight") or 1)
        self.ignorable = bool(cfg.get("ignorable"))
        self.node_cache_capable = bool(cfg.get("nodeCacheCapable"))
        # Resource names this extender manages (extender.go:99-112): with
        # a non-empty set the extender only engages for pods requesting
        # one of them; empty means every pod.
        self.managed_resources = frozenset(
            r.get("name") for r in cfg.get("managedResources") or [] if r.get("name")
        )
        self.timeout = 30.0

    @property
    def name(self) -> str:
        return self.url_prefix  # extender.go Name()

    def is_interested(self, pod: JSON) -> bool:
        """Upstream HTTPExtender.IsInterested: true when managedResources
        is empty, or any container (incl. init containers) requests or
        limits a managed resource (k8s pkg/scheduler/extender.go
        hasManagedResources)."""
        if not self.managed_resources:
            return True
        spec = pod.get("spec") or {}
        for c in (spec.get("containers") or []) + (spec.get("initContainers") or []):
            resources = c.get("resources") or {}
            for section in ("requests", "limits"):
                if any(
                    name in self.managed_resources
                    for name in (resources.get(section) or {})
                ):
                    return True
        return False

    def _send(self, verb: str, args: JSON) -> JSON:
        url = f"{self.url_prefix}/{verb}"
        req = urllib.request.Request(
            url,
            data=json.dumps(args).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            if resp.status != 200:
                raise ExtenderError(f"{verb} at {url}: HTTP {resp.status}")
            return json.loads(resp.read())

    def filter(self, args: JSON) -> JSON:
        if not self.filter_verb:
            raise ExtenderError("filterVerb is empty")
        return self._send(self.filter_verb, args)

    def prioritize(self, args: JSON) -> list[JSON]:
        if not self.prioritize_verb:
            raise ExtenderError("prioritizeVerb is empty")
        result = self._send(self.prioritize_verb, args)
        # Re-scale to the scheduler's score range (extender.go:142-147).
        factor = self.weight * (MAX_NODE_SCORE // MAX_EXTENDER_PRIORITY)
        return [
            {**hp, "score": int(hp.get("score") or 0) * factor} for hp in result or []
        ]

    def preempt(self, args: JSON) -> JSON:
        if not self.preempt_verb:
            raise ExtenderError("preemptVerb is empty")
        return self._send(self.preempt_verb, args)

    def bind(self, args: JSON) -> JSON:
        if not self.bind_verb:
            raise ExtenderError("bindVerb is empty")
        return self._send(self.bind_verb, args)


class ExtenderResultStore:
    """Per-pod request/response recording -> the 4 extender annotations
    (resultstore.go:15-198: each annotation is {extenderURL: result}).

    Bounded: entries flush to the pod (scheduler service, or its watch
    loop for proxy-driven external schedulers) and are deleted; the cap
    only guards against callers that never flush."""

    MAX_PODS = 4096

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._results: dict[str, dict[str, dict[str, JSON]]] = {}

    @staticmethod
    def _key(pod: JSON) -> str:
        return f"{namespace_of(pod)}/{name_of(pod)}"

    def _add(self, verb: str, pod: JSON, host: str, result: JSON) -> None:
        with self._lock:
            entry = self._results.setdefault(
                self._key(pod), {"filter": {}, "prioritize": {}, "preempt": {}, "bind": {}}
            )
            entry[verb][host] = result
            while len(self._results) > self.MAX_PODS:
                self._results.pop(next(iter(self._results)))

    def add_filter_result(self, args: JSON, result: JSON, host: str) -> None:
        self._add("filter", args.get("pod") or {}, host, result)

    def add_prioritize_result(self, args: JSON, result: JSON, host: str) -> None:
        self._add("prioritize", args.get("pod") or {}, host, result)

    def add_preempt_result(self, args: JSON, result: JSON, host: str) -> None:
        self._add("preempt", args.get("pod") or {}, host, result)

    def add_bind_result(self, args: JSON, result: JSON, host: str) -> None:
        self._add("bind", args.get("pod") or {}, host, result)

    def get_stored_result(self, pod: JSON) -> dict[str, str]:
        """The 4 annotations for one pod (empty maps marshal as "{}")."""
        with self._lock:
            entry = self._results.get(self._key(pod))
            if entry is None:
                return {}
            marshal = lambda o: json.dumps(o, sort_keys=True, separators=(",", ":"))
            return {
                EXTENDER_FILTER_RESULT_KEY: marshal(entry["filter"]),
                EXTENDER_PRIORITIZE_RESULT_KEY: marshal(entry["prioritize"]),
                EXTENDER_PREEMPT_RESULT_KEY: marshal(entry["preempt"]),
                EXTENDER_BIND_RESULT_KEY: marshal(entry["bind"]),
            }

    def delete_data(self, pod: JSON) -> None:
        with self._lock:
            self._results.pop(self._key(pod), None)


class ExtenderService:
    """Index-dispatched proxy with recording (service.go:18-85); the HTTP
    routes /api/v1/extender/<verb>/<id> call straight into this."""

    def __init__(self, extender_cfgs: Sequence[JSON] | None) -> None:
        self.extenders = [HTTPExtender(c) for c in (extender_cfgs or [])]
        self.store = ExtenderResultStore()

    def __bool__(self) -> bool:
        return bool(self.extenders)

    def filter(self, idx: int, args: JSON) -> JSON:
        result = self.extenders[idx].filter(args)
        self.store.add_filter_result(args, result, self.extenders[idx].name)
        return result

    def prioritize(self, idx: int, args: JSON) -> list[JSON]:
        result = self.extenders[idx].prioritize(args)
        self.store.add_prioritize_result(args, result, self.extenders[idx].name)
        return result

    def preempt(self, idx: int, args: JSON) -> JSON:
        result = self.extenders[idx].preempt(args)
        self.store.add_preempt_result(args, result, self.extenders[idx].name)
        return result

    def bind(self, idx: int, args: JSON) -> JSON:
        result = self.extenders[idx].bind(args)
        self.store.add_bind_result(args, result, self.extenders[idx].name)
        return result


def override_extenders_cfg_to_simulator(cfg: JSON, simulator_port: int) -> JSON:
    """Rewrite extender URLs so an external scheduler calls the simulator
    proxy (service.go:88-109)."""
    cfg = dict(cfg)
    extenders = [dict(e) for e in cfg.get("extenders") or []]
    for i, e in enumerate(extenders):
        e["enableHTTPS"] = False
        e.pop("tlsConfig", None)
        e["urlPrefix"] = f"http://localhost:{simulator_port}/api/v1/extender/"
        for verb in ("filterVerb", "prioritizeVerb", "preemptVerb", "bindVerb"):
            if e.get(verb):
                e[verb] = f"{verb[:-4].lower()}/{i}"
        extenders[i] = e
    cfg["extenders"] = extenders
    return cfg
