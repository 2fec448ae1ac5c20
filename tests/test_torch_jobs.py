"""The port's tenant job plane against ksim_tpu's, on the CPU.

Every test sends the same requests to ksim_tpu's job plane (JAX on the
CPU) and to the port's (``device="cpu"``: the plain versions of kernels
A and D) and holds the answers equal: status, result and SSE documents,
the journal's checkpoint records, the Chrome trace of a job's private
ring.  These fields are dropped from the comparisons, each because it
holds a time, a process id or a host-dependent value:

- status: ``created``, ``started``, ``finished`` (unix times) and
  ``lease.age`` (seconds);
- result: ``result.wallSeconds``, the seconds under ``phases`` (their
  names are compared) and under ``latency`` (each span's ``count`` is
  compared), and ``replay.kernel_ms`` (the port's kernel milliseconds);
- journal records: ``ts`` and ``created`` (unix times);
- SSE events and trace records: ``args.bytes`` of a ``jobs.checkpoint``
  event (the length of a record whose ``ts`` has a time-dependent number
  of digits);
- Chrome traces: ``ts``, ``dur``, ``pid``, ``tid`` and ``otherData``.

Three more are left out of the result comparison by design: the port
records one span ksim_tpu does not, ``replay.exec`` (the dispatch
worker's own interval, engine/replay.py); its replay evidence has no
``dev_const`` reuse counts to match ksim_tpu's (the two executors reuse
transfers differently); and ``replay.compile_cache`` is the process-wide
gate's evidence, which counts every job the process ran, so it is
compared on its own after a reset (``test_two_same_rung_jobs_launch_once``,
without the XLA disk-cache counters the port has no counterpart of and
the timing-dependent ``waits``).

The churns are small (24 nodes, 36 or 61 steps, three or four kernel D
segments of K=16 steps), never the 6k lock."""

from __future__ import annotations

import contextlib
import copy
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from ksim_tpu.engine.compilecache import COMPILE_CACHE as JAX_COMPILE_CACHE
from ksim_tpu.jobs import JobJournal as JaxJournal
from ksim_tpu.jobs import JobManager as JaxJobManager
from ksim_tpu.jobs import LeasePlane as JaxLeasePlane
from ksim_tpu.obs import TRACE as JAX_TRACE
from ksim_tpu.scenario import churn_scenario, spec_from_operations
from ksim_tpu.server import DIContainer as JaxDI
from ksim_tpu.server import SimulatorServer as JaxServer
from ksim_tpu_torch.engine.compilecache import COMPILE_CACHE
from ksim_tpu_torch.jobs import JobJournal, JobManager, LeasePlane
from ksim_tpu_torch.jobs.journal import JOURNAL_NAME
from ksim_tpu_torch.obs import TRACE
from ksim_tpu_torch.server import DIContainer, SimulatorServer
from tests.helpers import make_node, make_pod, sanitized_cpu_env

ROOT = Path(__file__).resolve().parents[1]

# Left out of the result documents' replay evidence (module docstring).
REPLAY_EVIDENCE_DROPPED = frozenset({"dev_const", "kernel_ms", "compile_cache"})
# ksim_tpu's compile-cache counters with no counterpart in the port (the
# XLA executable disk cache; the port's on-disk layer is the kernel
# library), and the count that depends on thread timing.
CACHE_KEYS_DROPPED = frozenset({"disk_evictions", "disk_hits", "disk_misses", "disk_speculative", "disk_stores",
                                "waits"})
PORT_ONLY_SPANS = frozenset({"replay.exec"})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _global_planes_alike(monkeypatch):
    """Both packages' global trace planes off for the test, whatever an
    earlier test in this process left on: a scheduling pass emits its
    ``service.pass`` event (into a job's log too) only while the global
    plane is active, so the two job planes' event logs differ unless the
    global planes agree."""
    for plane in (TRACE, JAX_TRACE):
        monkeypatch.setattr(plane, "_active", False)
        monkeypatch.setattr(plane, "_ring_on", False)


def churn_doc(n_events: int = 300, **sim_extra) -> dict:
    """A small in-vocabulary churn as a device-replay job document: 24
    nodes, 8 operations per step (36 steps at 300 events, 61 at 500)."""
    ops = list(churn_scenario(0, n_nodes=24, n_events=n_events, ops_per_step=8))
    sim = {"deviceReplay": True, "podBucketMin": 64, **sim_extra}
    return {"spec": {"simulator": sim, "scenario": spec_from_operations(ops)}}


def tiny_doc(n_pods: int = 3, **spec_extra) -> dict:
    ops = [{"step": 0, "createOperation": {"object": make_node(f"n{i}", cpu="4")}} for i in range(2)]
    ops += [{"step": i + 1, "createOperation": {"object": make_pod(f"p{i}", cpu="100m")}} for i in range(n_pods)]
    return {"spec": {"scenario": {"operations": ops}, **spec_extra}}


# ---------------------------------------------------------------------------
# Normalizing the documents (the dropped fields: module docstring)
# ---------------------------------------------------------------------------


def norm_status(st: dict) -> dict:
    st = {k: v for k, v in st.items() if k not in ("created", "started", "finished")}
    if st.get("lease"):
        st["lease"] = {k: v for k, v in st["lease"].items() if k != "age"}
    return st


def norm_result(doc: dict, *, port: bool) -> dict:
    doc = copy.deepcopy(doc)
    if isinstance(doc.get("result"), dict):
        doc["result"].pop("wallSeconds", None)
    if "phases" in doc:
        doc["phases"] = sorted(set(doc["phases"]) - PORT_ONLY_SPANS)
    if "latency" in doc:
        doc["latency"] = {n: h["count"] for n, h in doc["latency"].items() if n not in PORT_ONLY_SPANS}
    rep = doc.get("replay")
    if rep is not None:
        if port:
            assert {"dev_const", "kernel_ms"} <= set(rep)
        for key in REPLAY_EVIDENCE_DROPPED:
            rep.pop(key, None)
    return doc


def norm_event(ev: dict) -> dict:
    ev = copy.deepcopy(ev)
    if ev.get("name") == "jobs.checkpoint":
        ev["args"].pop("bytes", None)
    return ev


def norm_trace(doc: dict) -> tuple:
    """A Chrome trace as sorted (thread name, ph, name, args) records."""
    threads = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    return sorted(
        (threads[e["tid"]], e["ph"], e["name"], json.dumps(norm_event(e)["args"], sort_keys=True))
        for e in doc["traceEvents"]
        if e["ph"] != "M" and e["name"] not in PORT_ONLY_SPANS
    )


def canonical(body: bytes) -> str:
    return json.dumps(json.loads(body), sort_keys=True)


def norm_record(rec: dict, *, port: bool = False) -> dict:
    """A journal record without its times; a result record's document
    normalized as ``norm_result`` does."""
    rec = {k: v for k, v in rec.items() if k not in ("ts", "created")}
    if rec["t"] == "result":
        rec["result"] = norm_result(rec["result"], port=port)
    return rec


# ---------------------------------------------------------------------------
# HTTP plumbing: ksim_tpu's server and the port's, side by side
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def server_pair(tmp_path: "Path | None", **env):
    """[ksim_tpu, port] simulator servers, each with its own
    ``KSIM_JOBS_DIR`` under ``tmp_path`` (None: no journal) and ``env``
    set while its container (and so its JobManager) is built."""
    servers = []
    try:
        for name, di_cls, srv_cls, kw in (("jax", JaxDI, JaxServer, {}),
                                          ("port", DIContainer, SimulatorServer, {"device": "cpu"})):
            with pytest.MonkeyPatch.context() as mp:
                for k, v in env.items():
                    mp.setenv(k, str(v))
                if tmp_path is not None:
                    (tmp_path / name).mkdir(exist_ok=True)
                    mp.setenv("KSIM_JOBS_DIR", str(tmp_path / name))
                else:
                    mp.delenv("KSIM_JOBS_DIR", raising=False)
                di = di_cls(**kw)
                di.job_manager  # built under this env
            servers.append(srv_cls(di, port=0).start())
        yield servers
    finally:
        for srv in servers:
            srv.shutdown_server()
            srv.di.shutdown(timeout=30)


def req(srv, method, path, body=None, headers=None):
    """One request: (status, headers, body bytes)."""
    c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
    try:
        data = None if body is None else json.dumps(body).encode()
        c.request(method, path, data, {"Content-Type": "application/json", **(headers or {})})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


def both(servers, method, path, body=None, headers=None):
    """The same request to both servers: [(status, headers, json), ...]."""
    out = []
    for srv in servers:
        status, hdrs, data = req(srv, method, path, copy.deepcopy(body), headers)
        out.append((status, hdrs, json.loads(data) if data else None))
    return out


def read_sse(srv, path, deadline_s: float = 120.0) -> list:
    """Every SSE data frame until the server ends the stream."""
    c = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=deadline_s)
    c.request("GET", path, headers={"Accept": "text/event-stream"})
    resp = c.getresponse()
    assert resp.status == 200 and resp.getheader("Content-Type") == "text/event-stream"
    events = []
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        line = resp.readline()
        if not line:
            break
        if line.startswith(b"data: "):
            events.append(json.loads(line[len(b"data: "):]))
    c.close()
    return events


def wait_state(job, states, deadline_s: float = 120.0) -> dict:
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        st = job.status()
        if st["state"] in states:
            return st
        time.sleep(0.02)
    raise AssertionError(f"job {job.id} never reached {states}: {job.status()}")


# ---------------------------------------------------------------------------
# The lifecycle over HTTP: a solo device-replay job, a lane job, a job
# whose dispatch fault lands in its own ring; restart byte-identical
# ---------------------------------------------------------------------------


def test_solo_and_lane_jobs_over_http_then_restart(tmp_path, monkeypatch):
    """Submit, follow the SSE stream, read status, result, trace and the
    list, cancel a finished job: both planes answer alike for a solo
    kernel D job, a ``fleet: 2`` lane job (kernel D's lanes entry) and a
    job whose spec arms ``replay.dispatch``.  That fault fires on the
    dispatch worker, and its ``fault.fired`` event and the worker's spans
    land in the job's own ring, not in the global one.  After a restart
    each server serves the finished results byte for byte (sorted keys)."""
    # The global rings on, in both packages alike (a site may check the
    # global plane's ``active``): nothing a job's dispatch worker records
    # may land there.
    for plane in (TRACE, JAX_TRACE):
        monkeypatch.setattr(plane, "_active", True)
        monkeypatch.setattr(plane, "_ring_on", True)
    t_start = time.perf_counter_ns()
    docs = {
        "solo": churn_doc(),
        "lanes": churn_doc(fleet=2),
        "fault": churn_doc(),
    }
    docs["fault"]["spec"]["faults"] = {"replay.dispatch": "call:2@device"}
    env = {"KSIM_JOBS_WORKERS": 1, "KSIM_JOBS_CHECKPOINT_EVERY": 1}
    bodies: dict[str, list] = {}
    with server_pair(tmp_path, **env) as servers:
        ids = {}
        for name, doc in docs.items():
            (js, _, jb), (ps, _, pb) = both(servers, "POST", "/api/v1/jobs", doc)
            assert (js, ps) == (202, 202)
            assert pb["id"] == jb["id"] and {pb["state"], jb["state"]} <= {"queued", "running"}
            ids[name] = pb["id"]
        for name, jid in ids.items():
            sse = [[norm_event(e) for e in read_sse(srv, f"/api/v1/jobs/{jid}/events")] for srv in servers]
            assert sse[1] == sse[0], name
            assert sse[1][-1]["state"] == "succeeded"
            (_, _, jst), (_, _, pst) = both(servers, "GET", f"/api/v1/jobs/{jid}")
            assert norm_status(pst) == norm_status(jst), name
            (js, _, jres), (ps, _, pres) = both(servers, "GET", f"/api/v1/jobs/{jid}/result")
            assert js == ps == 200
            assert norm_result(pres, port=True) == norm_result(jres, port=False), name
            bodies[name] = [req(srv, "GET", f"/api/v1/jobs/{jid}/result")[2] for srv in servers]
            (_, _, jtr), (_, _, ptr) = both(servers, "GET", f"/api/v1/jobs/{jid}/trace")
            assert norm_trace(ptr) == norm_trace(jtr), name
            assert all(e["args"].get("job") == jid for e in ptr["traceEvents"] if e["ph"] != "M")
        solo = json.loads(bodies["solo"][1])
        assert solo["result"]["podsScheduled"] > 0 and solo["replay"]["device_steps"] == solo["result"]["steps"]
        lanes = json.loads(bodies["lanes"][1])
        assert lanes["lanes"] == [[solo["result"]["podsScheduled"], solo["result"]["unschedulableAttempts"]]] * 2
        # The dispatch fault: contained (one segment per pass), counts
        # unchanged; fault.fired and the worker's replay.exec spans are
        # in the job's ring, on the replay-dispatch thread.
        fault = json.loads(bodies["fault"][1])
        assert fault["result"] == solo["result"] | {"wallSeconds": fault["result"]["wallSeconds"]}
        assert fault["replay"]["device_errors"] == 1
        ring = json.loads(req(servers[1], "GET", f"/api/v1/jobs/{ids['fault']}/trace")[2])["traceEvents"]
        threads = {e["tid"]: e["args"]["name"] for e in ring if e["ph"] == "M"}
        fired = [e for e in ring if e["name"] == "fault.fired"]
        assert [e["args"]["site"] for e in fired] == ["replay.dispatch"]
        assert threads[fired[0]["tid"]] == "replay-dispatch"
        assert any(e["name"] == "replay.exec" and threads[e["tid"]] == "replay-dispatch" for e in ring)
        leaked = [r["name"] for r in TRACE.ring_records() if r["t"] >= t_start
                  and r["name"] in ("replay.exec", "replay.dispatch", "fault.fired", "replay.reconcile")]
        assert not leaked
        # The list, cancels of a finished and an unknown job, bad paths.
        (_, _, jl), (_, _, pl) = both(servers, "GET", "/api/v1/jobs")
        assert [norm_status(s) for s in pl["items"]] == [norm_status(s) for s in jl["items"]]
        for method, path in (("DELETE", f"/api/v1/jobs/{ids['solo']}"), ("DELETE", "/api/v1/jobs/nope"),
                             ("GET", "/api/v1/jobs/nope"), ("GET", f"/api/v1/jobs/{ids['solo']}/nope"),
                             ("POST", f"/api/v1/jobs/{ids['solo']}")):
            (js, _, jb), (ps, _, pb) = both(servers, method, path)
            assert (ps, pb) == (js, jb), (method, path)
        # The journals' checkpoint records, record for record.
        cks = [[norm_record(r) for r in journal_cls(str(tmp_path / name / JOURNAL_NAME)).replay() if r["t"] == "checkpoint"]
               for name, journal_cls in (("jax", JaxJournal), ("port", JobJournal))]
        assert len(cks[1]) >= 4 and cks[1] == cks[0]  # the solo job's three segments, the fault job's
    with server_pair(tmp_path, **env) as servers:
        for name, jid in ids.items():
            # Byte for byte in canonical form: the journal stores the
            # document with sorted keys, as ksim_tpu's does.
            after = [canonical(req(srv, "GET", f"/api/v1/jobs/{jid}/result")[2]) for srv in servers]
            assert after == [canonical(b) for b in bodies[name]], name


# ---------------------------------------------------------------------------
# Admission: bad specs, 413, 429 (queue full; tenant throttle with
# Retry-After)
# ---------------------------------------------------------------------------

ADMISSION_CASES = {
    "bad_specs": ({}, [
        {"spec": {}},
        {"spec": {"scenario": {"operations": []}, "initialSnapshotPath": "/etc/x"}},
        {"spec": {"simulator": {"initialSnapshotPath": "/etc/passwd"}, "scenario": {"operations": []}}},
        {"spec": {"simulator": {"fleet": 2, "schedulerConfig": {"profiles": [{}]}}, "scenario": {"operations": []}}},
        tiny_doc(1, faults={"service.schedule": "always"}),
        tiny_doc(1, faults={"replay.dispatch": "always;service.schedule=always"}),
        tiny_doc(1, priority="high"),
        [1, 2],
    ]),
    "over_bounds_413": ({"KSIM_JOBS_MAX_EVENTS": 4, "KSIM_JOBS_MAX_NODES": 1}, [tiny_doc(1), tiny_doc(3)]),
    "queue_full_429": ({"KSIM_JOBS_WORKERS": 0, "KSIM_JOBS_QUEUE": 1}, [tiny_doc(1), tiny_doc(1)]),
    "tenant_rate_429": ({"KSIM_JOBS_WORKERS": 0, "KSIM_JOBS_TENANT_RATE": 0.01}, [tiny_doc(1), tiny_doc(1)]),
    "tenant_active_429": ({"KSIM_JOBS_WORKERS": 0, "KSIM_JOBS_TENANT_MAX_ACTIVE": 1}, [tiny_doc(1), tiny_doc(1)]),
}


@pytest.mark.parametrize("case", sorted(ADMISSION_CASES))
def test_admission_answers(case):
    """Refusals answer alike: the status, the message, and the throttle's
    ``Retry-After`` header; the metrics document's queue and tenant
    evidence after the requests."""
    env, docs = ADMISSION_CASES[case]
    with server_pair(None, **env) as servers:
        answers = []
        for doc in docs:
            (js, jh, jb), (ps, ph, pb) = both(servers, "POST", "/api/v1/jobs", doc, {"X-Ksim-Tenant": "acme"})
            assert ps == js and ph.get("Retry-After") == jh.get("Retry-After"), (case, doc)
            assert (norm_status(pb) if ps == 202 else pb) == (norm_status(jb) if js == 202 else jb), (case, doc)
            answers.append(ps)
        (_, _, jm), (_, _, pm) = both(servers, "GET", "/api/v1/metrics")
        assert pm["jobs"]["queue"] == jm["jobs"]["queue"]
        assert {t: {k: v for k, v in e.items() if k != "tokens"} for t, e in pm["jobs"]["tenants"].items()} == {
            t: {k: v for k, v in e.items() if k != "tokens"} for t, e in jm["jobs"]["tenants"].items()}
    expected = {"bad_specs": [400] * 8, "over_bounds_413": [413, 413], "queue_full_429": [202, 429],
                "tenant_rate_429": [202, 429], "tenant_active_429": [202, 429]}[case]
    assert answers == expected


# ---------------------------------------------------------------------------
# Faults, cancel, the compile-once gate
# ---------------------------------------------------------------------------


def test_spec_fault_degrades_only_the_submitting_job():
    """A job arming ``jobs.run`` in its own spec fails alone; its
    neighbour, submitted right after, succeeds; both planes agree."""
    with server_pair(None, KSIM_JOBS_WORKERS=2) as servers:
        bad = both(servers, "POST", "/api/v1/jobs", tiny_doc(2, faults={"jobs.run": "always"}))
        good = both(servers, "POST", "/api/v1/jobs", tiny_doc(2))
        for (_, _, jb), srv in zip(bad + good, servers + servers):
            srv.di.job_manager.get(jb["id"]).wait_done(60)
        for answers in (bad, good):
            jid = answers[1][2]["id"]
            (_, _, jst), (_, _, pst) = both(servers, "GET", f"/api/v1/jobs/{jid}")
            assert norm_status(pst) == norm_status(jst)
            (_, _, jres), (_, _, pres) = both(servers, "GET", f"/api/v1/jobs/{jid}/result")
            assert norm_result(pres, port=True) == norm_result(jres, port=False)
        states = [both(servers, "GET", f"/api/v1/jobs/{a[1][2]['id']}")[1][2] for a in (bad, good)]
        assert [s["state"] for s in states] == ["failed", "succeeded"]
        assert states[0]["error"].startswith("InjectedFault")


def test_cancel_mid_segment_rolls_back_the_store():
    """A cancel inside the first segment's reconcile (held open by the
    job's private ``replay.reconcile`` hang) rolls the store back to the
    segment's start: empty, in both planes, and the job ends cancelled."""
    outcomes = []
    for cls, kw in ((JaxJobManager, {}), (JobManager, {"device": "cpu"})):
        jm = cls(workers=1, queue_limit=4, fault_spec="0:replay.reconcile=hang:1.5:1", **kw)
        try:
            job = jm.submit(churn_doc())
            idx, seen, end = 0, False, time.monotonic() + 120
            while time.monotonic() < end and not seen:
                evs, idx, done = job.events_since(idx, timeout=0.5)
                seen = any(e.get("name") == "fault.fired" for e in evs)
                assert not done
            assert jm.cancel(job.id) == "running"
            assert job.wait_done(60)
            events = [norm_event(e) for e in job.events_since(0)[0]]
            outcomes.append((norm_status(job.status()), events, job.store.list("pods"), job.store.list("nodes")))
        finally:
            jm.shutdown(timeout=5)
    assert outcomes[1] == outcomes[0]
    assert outcomes[1][0]["state"] == "cancelled" and outcomes[1][2:] == ([], [])


def test_two_same_rung_jobs_launch_once():
    """Two identical device-replay jobs on two workers share every rung:
    one first launch (one miss) each, hits from the second tenant, both
    jobs owning the rung; the gate's counts equal ksim_tpu's compile
    cache's."""
    snaps, results = [], []
    for cls, cache, kw in ((JaxJobManager, JAX_COMPILE_CACHE, {}), (JobManager, COMPILE_CACHE, {"device": "cpu"})):
        cache.reset()
        jm = cls(workers=2, queue_limit=4, **kw)
        try:
            doc = churn_doc()
            jobs = [jm.submit(doc), jm.submit(doc)]
            assert jm.join(timeout=300)
            results.append([norm_result(j.result_view()[1], port=cls is JobManager)["result"] for j in jobs])
            snaps.append({k: v for k, v in cache.snapshot().items() if k not in CACHE_KEYS_DROPPED})
        finally:
            jm.shutdown(timeout=5)
    assert results[1] == results[0] and results[1][0] == results[1][1]
    assert snaps[1] == snaps[0]
    assert snaps[1]["shared_rungs"] >= 1 and snaps[1]["shared_single_compile_rungs"] >= 1
    assert snaps[1]["max_owners_per_rung"] == 2 and snaps[1]["aborts"] == 0


# ---------------------------------------------------------------------------
# Durability: interrupted vs resumed, resume from every checkpoint
# ---------------------------------------------------------------------------


def _rewrite(journal_cls, path: str, recs: list) -> None:
    os.unlink(path)
    j = journal_cls(path)
    for r in recs:
        j.append(r)


def test_interrupted_then_resumed_from_every_checkpoint(tmp_path):
    """Cut the journal after each checkpoint record in turn (the crash
    window), restart: without ``resume`` the job is ``interrupted``, with
    it the job resumes from that checkpoint and ends with the
    uninterrupted run's counts, replaying strictly fewer events the later
    the checkpoint.  Both planes agree at every step, and their
    checkpoint records (store, carries, partial result) are equal."""
    planes = {"jax": (JaxJobManager, JaxJournal, {}), "port": (JobManager, JobJournal, {"device": "cpu"})}
    full, recs = {}, {}
    for name, (cls, journal_cls, kw) in planes.items():
        d = tmp_path / name
        d.mkdir()
        jm = cls(workers=1, queue_limit=8, jobs_dir=str(d), checkpoint_every=1, **kw)
        job = jm.submit(churn_doc())
        assert wait_state(job, {"succeeded", "failed"})["state"] == "succeeded"
        full[name] = job.result_view()[1]
        jm.shutdown()
        recs[name] = journal_cls(str(d / JOURNAL_NAME)).replay()
    # Record for record; the worker's ``running`` record may land before
    # the submitting thread's ``submit`` record, so the other records
    # are compared as a multiset.
    for name in recs:
        assert [r["t"] for r in recs[name]].count("checkpoint") == 3
    assert ([norm_record(r) for r in recs["port"] if r["t"] == "checkpoint"]
            == [norm_record(r) for r in recs["jax"] if r["t"] == "checkpoint"])
    assert (sorted(json.dumps(norm_record(r, port=True), sort_keys=True) for r in recs["port"])
            == sorted(json.dumps(norm_record(r), sort_keys=True) for r in recs["jax"]))
    cut = [i for i, r in enumerate(recs["port"]) if r["t"] == "checkpoint"]
    assert len(cut) == 3
    replayed = []
    for idx in cut:
        seen = {}
        for name, (cls, journal_cls, kw) in planes.items():
            path = str(tmp_path / name / JOURNAL_NAME)
            _rewrite(journal_cls, path, recs[name][: idx + 1])
            jm = cls(workers=1, queue_limit=8, jobs_dir=str(tmp_path / name), **kw)
            interrupted = norm_status(jm.get("job-000000").status())
            jm.shutdown()
            jm = cls(workers=1, queue_limit=8, jobs_dir=str(tmp_path / name), resume=True, checkpoint_every=0, **kw)
            job = jm.get("job-000000")
            st = wait_state(job, {"succeeded", "failed", "interrupted"})
            res = job.result_view()[1]
            jm.shutdown()
            seen[name] = (interrupted, norm_status(st), norm_result(res, port=name == "port"))
            assert norm_result(res, port=name == "port")["result"] == norm_result(full[name], port=name == "port")["result"]
        assert seen["port"] == seen["jax"]
        interrupted, st, res = seen["port"]
        assert interrupted["state"] == "interrupted" and st["state"] == "succeeded"
        assert st["resumed_from"] == recs["port"][idx]["segment"] and res["resume"]["cursor"] == recs["port"][idx]["cursor"]
        replayed.append(res["resume"]["eventsReplayed"])
    assert replayed == sorted(replayed, reverse=True) and replayed[0] < full["port"]["result"]["eventsApplied"]


# ---------------------------------------------------------------------------
# The journal's torn tail and bad CRC; the lease plane
# ---------------------------------------------------------------------------

_RECS = [
    {"t": "submit", "id": "a", "ordinal": 0, "priority": 0, "doc": {"x": 1}},
    {"t": "state", "id": "a", "state": "running", "ts": 1.0},
    {"t": "state", "id": "a", "state": "succeeded", "ts": 2.0},
]
JOURNAL_DAMAGE = {
    "torn_tail": lambda lines: lines + [b'{"crc": 123, "rec": {"t": "state", "id": "a", "sta'],
    "bad_crc": lambda lines: lines[:1] + [json.dumps({"crc": 1, "rec": _RECS[1]}).encode() + b"\n"] + lines[2:],
    "garbage": lambda lines: [b"not json at all\n"] + lines,
}


@pytest.mark.parametrize("damage", sorted(JOURNAL_DAMAGE))
def test_journal_damage_is_repaired_alike(tmp_path, damage):
    """The same damaged bytes, written by ksim_tpu's journal, replay to
    the same records in both journals, which truncate the same bytes and
    leave the same file behind; the port then appends records ksim_tpu
    reads back."""
    files = {}
    for name, journal_cls in (("jax", JaxJournal), ("port", JobJournal)):
        path = str(tmp_path / f"{name}.jsonl")
        writer = JaxJournal(path)
        for r in _RECS:
            writer.append(r)
        with open(path, "rb") as f:
            lines = f.readlines()
        with open(path, "wb") as f:
            f.write(b"".join(JOURNAL_DAMAGE[damage](lines)))
        j = journal_cls(path)
        recs = j.replay()
        with open(path, "rb") as f:
            files[name] = (recs, j.snapshot()["truncated_bytes"], f.read())
    assert files["port"] == files["jax"]
    j = JobJournal(str(tmp_path / "port.jsonl"))
    j.append({"t": "cancel", "id": "a", "ts": 3.0})
    assert JaxJournal(j.path).replay() == files["jax"][0] + [{"t": "cancel", "id": "a", "ts": 3.0}]


class _FakeClock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def test_lease_claim_race_and_takeover(tmp_path):
    """Two members race for one job: exactly one wins; the live lease
    refuses the other; past expiry the survivor takes over with a bumped
    epoch and the dead owner cannot renew back in; a released lease is
    never re-claimed.  The lease files and counters of both planes are
    equal, and each plane folds the other's file alike."""
    outcomes = {}
    for name, plane_cls in (("jax", JaxLeasePlane), ("port", LeasePlane)):
        d = tmp_path / name
        d.mkdir()
        clock = _FakeClock()
        a, b = (plane_cls(str(d), worker=w, lease_s=10.0, clock=clock) for w in ("wA", "wB"))
        barrier = threading.Barrier(2)
        won = {}

        def race(w, plane):
            barrier.wait()
            won[w] = plane.claim("job-0")

        threads = [threading.Thread(target=race, args=(w, p)) for w, p in (("wA", a), ("wB", b))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        winners = [w for w, lease in won.items() if lease is not None]
        assert len(winners) == 1
        owner, other = (a, b) if winners == ["wA"] else (b, a)
        clock.t += 5.0
        refused = other.claim("job-0")
        clock.t += 6.0
        takeover = other.claim("job-0")
        renewed = owner.renew(["job-0"])
        other.release("job-0")
        clock.t += 10_000.0
        reclaimed = [a.claim("job-0"), b.claim("job-0")]
        outcomes[name] = (refused, {k: v for k, v in takeover.items() if k != "worker"}, renewed, reclaimed,
                          sorted(c for w in a.counters().values() for c in w.items()),
                          {k: {kk: vv for kk, vv in v.items() if kk != "worker"} for k, v in a.leases().items()})
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][1]["epoch"] == 2 and outcomes["port"][2] == 0
    for name in ("jax", "port"):
        assert LeasePlane(str(tmp_path / name), worker="wC").leases() == JaxLeasePlane(
            str(tmp_path / name), worker="wC").leases()


# ---------------------------------------------------------------------------
# A front door and worker processes: ?scope=fleet, SIGKILL then resume
# ---------------------------------------------------------------------------


def _spawn_worker(jobs_dir: Path, worker_id: str) -> subprocess.Popen:
    env = sanitized_cpu_env({
        "KSIM_WORKERS_LEASE_S": "2", "KSIM_WORKERS_HEARTBEAT_S": "0.5", "KSIM_WORKERS_POLL_S": "0.1",
        "KSIM_OBS_PUBLISH_S": "0.2", "KSIM_JOBS_CHECKPOINT_EVERY": "1", "KSIM_JOBS_WORKERS": "1",
    })
    proc = subprocess.Popen(
        [sys.executable, "-m", "ksim_tpu_torch.jobs", "--dir", str(jobs_dir), "--worker-id", worker_id,
         "--device", "cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    ready: list[str] = []
    reader = threading.Thread(target=lambda: ready.append(proc.stdout.readline()), daemon=True)
    reader.start()
    reader.join(90)
    assert ready and ready[0].strip() == f"READY {worker_id}", ready
    return proc


def _stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)


def _first_checkpoint(path: Path, jid: str, deadline_s: float = 120.0) -> None:
    """Block until the journal holds ``jid``'s first checkpoint record."""
    end = time.monotonic() + deadline_s
    needle = f'"id":"{jid}"'.encode()
    while time.monotonic() < end:
        with contextlib.suppress(FileNotFoundError), open(path, "rb") as f:
            if any(b'"t":"checkpoint"' in line and needle in line for line in f):
                return
        time.sleep(0.01)
    raise AssertionError(f"no checkpoint record for {jid}")


def test_front_door_and_worker_processes(tmp_path, monkeypatch):
    """A front door (the port's server, ``KSIM_WORKERS_ROLE=frontdoor``)
    and a ``python -m ksim_tpu_torch.jobs --device cpu`` worker: the
    worker runs a job to the same result as ksim_tpu's plane, and
    ``?scope=fleet`` folds its published snapshot.  Then a device-replay
    job's worker is SIGKILLed after the journal's first checkpoint
    record; a second worker takes the expired lease over and resumes
    from that checkpoint to ksim_tpu's counts.  The job's spec holds
    each of its first two dispatches for 1.5 s (a ``hang`` fault, which
    changes no count), so the kill lands while the second one waits."""
    held_doc = churn_doc()
    held_doc["spec"]["faults"] = {"replay.dispatch": "hang:1.5:2"}
    reference = {}
    jm = JaxJobManager(workers=1, queue_limit=4)
    try:
        for name, doc in (("tiny", tiny_doc(3)), ("long", churn_doc())):
            job = jm.submit(doc)
            assert job.wait_done(300)
            reference[name] = norm_result(job.result_view()[1], port=False)
    finally:
        jm.shutdown()
    monkeypatch.setenv("KSIM_JOBS_DIR", str(tmp_path))
    monkeypatch.setenv("KSIM_WORKERS_ROLE", "frontdoor")
    monkeypatch.setenv("KSIM_WORKER_ID", "fd")
    monkeypatch.setenv("KSIM_WORKERS_POLL_S", "0.1")
    monkeypatch.setenv("KSIM_WORKERS_LEASE_S", "2")
    di = DIContainer(device="cpu")
    srv = SimulatorServer(di, port=0).start()
    workers = [_spawn_worker(tmp_path, "w1")]
    try:
        status, _, body = req(srv, "POST", "/api/v1/jobs", tiny_doc(3))
        assert status == 202
        tiny = json.loads(body)["id"]
        assert wait_state(di.job_manager.get(tiny), {"succeeded", "failed"})["state"] == "succeeded"
        status, _, body = req(srv, "GET", f"/api/v1/jobs/{tiny}/result")
        got = norm_result(json.loads(body), port=True)
        assert got["result"] == reference["tiny"]["result"] and got["latency"] == reference["tiny"]["latency"]
        end = time.monotonic() + 30
        while time.monotonic() < end:
            fleet = json.loads(req(srv, "GET", "/api/v1/metrics?scope=fleet")[2])
            if "w1" in fleet["workers"] and fleet["counters"]:
                break
            time.sleep(0.1)
        assert set(fleet["workers"]) == {"fd", "w1"} and not fleet["workers"]["w1"]["stale"]
        assert fleet["workers"]["w1"]["process"]["role"] == "worker"
        # The device-replay job: SIGKILL its worker after the first
        # checkpoint record, then a survivor resumes it.
        status, _, body = req(srv, "POST", "/api/v1/jobs", held_doc)
        jid = json.loads(body)["id"]
        _first_checkpoint(tmp_path / JOURNAL_NAME, jid)
        os.kill(workers[0].pid, signal.SIGKILL)
        workers[0].wait(30)
        workers.append(_spawn_worker(tmp_path, "w2"))
        final = wait_state(di.job_manager.get(jid), {"succeeded", "failed"}, 180.0)
        assert final["state"] == "succeeded" and final["owner"] == "w2", final
        res = json.loads(req(srv, "GET", f"/api/v1/jobs/{jid}/result")[2])
        assert norm_result(res, port=True)["result"] == reference["long"]["result"]
        assert res["resume"]["fromSegment"] >= 1
        assert res["resume"]["eventsReplayed"] < reference["long"]["result"]["eventsApplied"]
    finally:
        for proc in workers:
            _stop(proc)
        srv.shutdown_server()
        di.shutdown(timeout=30)
