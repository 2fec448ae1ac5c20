"""Built-in web UI.

The reference ships a ~5k-LoC Nuxt2/Vuetify app (reference web/) that is
a pure client of the REST + annotation contract; this single-file page
covers that app's workflow against THIS server: live tables for all 7
resource kinds fed by the streaming /api/v1/listwatchresources endpoint,
a per-node pod board with an "unscheduled" bucket (the reference's
pods-by-node store, web/store/pod.ts:12-16,43-51), per-plugin
Filter/Score/FinalScore tables decoded from the 13 result annotations
with a result-history attempt browser (SchedulingResults.vue), resource
create from prefilled templates — pasted YAML manifests create too —
(ResourceAddButton.vue), view/edit of any live resource round-tripped
through the /api/v1/resources CRUD as YAML (default) or JSON (the
YamlEditor.vue + server-side-apply workflow, web/api/v1/pod.ts:22-53;
YAML conversion is server-side, http.py _yaml/_body), delete, a
scheduler-configuration editor with the same YAML/JSON toggle
(SchedulerConfigurationEditButton.vue), snapshot export/import and reset
(TopBar/), and a metrics panel.  Served at / by SimulatorServer."""

INDEX_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8"/>
<title>ksim-tpu simulator</title>
<style>
  body { font-family: system-ui, sans-serif; margin: 1.2rem; color: #222; }
  h1 { font-size: 1.2rem; } h2 { font-size: 1rem; margin-top: 1.1rem; }
  table { border-collapse: collapse; margin-top: .4rem; font-size: .85rem; }
  th, td { border: 1px solid #ccc; padding: .22rem .5rem; text-align: left; }
  th { background: #f3f3f3; }
  .pill { display: inline-block; padding: 0 .5rem; border-radius: 999px;
          background: #e8f0fe; margin-right: .3rem; }
  .pending { background: #fde8e8; }
  button { margin-right: .4rem; }
  #results pre, #metrics pre, pre { background: #f8f8f8; padding: .5rem; overflow-x: auto; }
  tr[data-pod] { cursor: pointer; }
  .tab { cursor: pointer; padding: .2rem .7rem; border: 1px solid #ccc;
         border-bottom: none; display: inline-block; background: #f3f3f3; }
  .tab.active { background: #fff; font-weight: 600; }
  textarea { width: 100%; min-height: 10rem; font-family: monospace; }
  .panel { border: 1px solid #ccc; padding: .6rem; margin-top: .4rem; }
  .del, .edit { color: #a00; cursor: pointer; }
  .edit { color: #06c; margin-right: .5rem; }
  #board { display: flex; flex-wrap: wrap; gap: .6rem; margin-top: .4rem; }
  .bucket { border: 1px solid #ccc; border-radius: 4px; padding: .4rem .6rem;
            min-width: 11rem; vertical-align: top; background: #fafafa; }
  .bucket h3 { margin: 0 0 .3rem; font-size: .9rem; }
  .bucket.unsched { background: #fff4f4; }
  .bpod { display: block; cursor: pointer; font-size: .85rem; padding: .05rem 0; }
  .bpod:hover { text-decoration: underline; }
  .attempt { cursor: pointer; padding: .1rem .5rem; border: 1px solid #ccc;
             display: inline-block; margin-right: .25rem; background: #f3f3f3; }
  .attempt.active { background: #fff; font-weight: 600; }
</style>
</head>
<body>
<h1>ksim-tpu scheduler simulator</h1>
<div>
  <button onclick="doExport()">Export snapshot</button>
  <button onclick="importFile.click()">Import snapshot</button>
  <input type="file" id="importFile" style="display:none" onchange="doImport(this)"/>
  <button onclick="doReset()">Reset cluster</button>
  <button onclick="toggle('config', loadConfig)">Scheduler config</button>
  <button onclick="toggle('metrics', loadMetrics)">Metrics</button>
  <button onclick="toggle('boardPanel', renderBoard)">Pod board</button>
  <span id="status" class="pill">connecting…</span>
</div>

<div id="config" class="panel" style="display:none">
  <b>KubeSchedulerConfiguration</b> (applying compiles the new
  kernel set — the reference's scheduler restart)
  <span id="configFmtBtns"></span><br/>
  <textarea id="configText"></textarea><br/>
  <button onclick="applyConfig()">Apply</button>
  <button onclick="loadConfig()">Reload current</button>
  <span id="configMsg"></span>
</div>

<div id="metrics" class="panel" style="display:none"><pre id="metricsPre"></pre></div>

<div id="boardPanel" class="panel" style="display:none">
  <b>Pods by node</b> (unscheduled bucket first — web/store/pod.ts)
  <div id="board"></div>
</div>

<div style="margin-top:1rem" id="tabs"></div>
<div class="panel" id="tabpanel">
  <div>
    <b id="kindTitle"></b>
    <button onclick="showAdd()">Add…</button>
    <span id="kindCount" class="pill"></span>
  </div>
  <div id="addPanel" style="display:none">
    <textarea id="addText"></textarea><br/>
    <button onclick="doAdd()">Create</button>
    <span id="addMsg"></span>
  </div>
  <div id="editPanel" style="display:none">
    <b>Edit <span id="editKey"></span></b> (live object; Save PUTs it back)
    <span id="editFmtBtns"></span><br/>
    <textarea id="editText"></textarea><br/>
    <button onclick="doSave()">Save</button>
    <button onclick="hideEdit()">Cancel</button>
    <span id="editMsg"></span>
  </div>
  <table id="resTable"><thead></thead><tbody></tbody></table>
</div>

<h2>Scheduling results <small>(click a pod row)</small></h2>
<div id="results">none selected</div>

<script>
const PREFIX = "kube-scheduler-simulator.sigs.k8s.io/";
const KINDS = ["pods","nodes","persistentvolumes","persistentvolumeclaims",
               "storageclasses","priorityclasses","namespaces"];
const store = Object.fromEntries(KINDS.map(k => [k, new Map()]));
let activeKind = "pods";
let selectedPod = null;
let selectedAttempt = -1;  // -1 = latest (live annotations)

// New-resource templates (the reference's web/components/lib/templates).
const TEMPLATES = {
  pods: {metadata:{name:"pod-new",namespace:"default"},spec:{containers:[
    {name:"c",image:"registry.k8s.io/pause:3.9",resources:{requests:{cpu:"100m",memory:"128Mi"}}}]}},
  nodes: {metadata:{name:"node-new"},status:{allocatable:{cpu:"4",memory:"8Gi",pods:"110"},
    capacity:{cpu:"4",memory:"8Gi",pods:"110"}}},
  persistentvolumes: {metadata:{name:"pv-new"},spec:{capacity:{storage:"1Gi"},
    accessModes:["ReadWriteOnce"],persistentVolumeReclaimPolicy:"Delete"},status:{phase:"Available"}},
  persistentvolumeclaims: {metadata:{name:"pvc-new",namespace:"default"},spec:{
    accessModes:["ReadWriteOnce"],resources:{requests:{storage:"1Gi"}}}},
  storageclasses: {metadata:{name:"sc-new"},provisioner:"kubernetes.io/no-provisioner",
    volumeBindingMode:"WaitForFirstConsumer"},
  priorityclasses: {metadata:{name:"pc-new"},value:1000},
  namespaces: {metadata:{name:"ns-new"}},
};

// All interpolated data is escaped: snapshots/annotations are untrusted.
function esc(s) {
  return String(s).replace(/[&<>"']/g, c => ({
    "&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));
}
function keyOf(obj) {
  const md = (obj||{}).metadata||{};
  return (md.namespace ? md.namespace+"/" : "") + md.name;
}

function renderTabs() {
  document.getElementById("tabs").innerHTML = KINDS.map(k =>
    `<span class="tab ${k===activeKind?"active":""}" onclick="setKind('${k}')">${k} (${store[k].size})</span>`).join("");
}
function setKind(k) {
  activeKind = k;
  document.getElementById("addPanel").style.display = "none";
  hideEdit();
  render();
}

const COLS = {
  pods: ["node", "phase", "selected-node"],
  nodes: ["cpu", "memory", "pods", "unschedulable"],
  persistentvolumes: ["capacity", "phase", "claimRef"],
  persistentvolumeclaims: ["volumeName", "storageClassName"],
  storageclasses: ["provisioner", "bindingMode"],
  priorityclasses: ["value"],
  namespaces: [],
};
function cols(kind, o) {
  const md = o.metadata||{}, spec = o.spec||{}, st = o.status||{};
  switch (kind) {
    case "pods": return [spec.nodeName||"", st.phase||"Pending",
      ((md.annotations||{})[PREFIX+"selected-node"])||""];
    case "nodes": { const a = st.allocatable||{};
      return [a.cpu||"", a.memory||"", a.pods||"", spec.unschedulable?"true":""]; }
    case "persistentvolumes": return [((spec.capacity||{}).storage)||"", st.phase||"",
      spec.claimRef ? keyOf({metadata:spec.claimRef}) : ""];
    case "persistentvolumeclaims": return [spec.volumeName||"", spec.storageClassName||""];
    case "storageclasses": return [o.provisioner||"", o.volumeBindingMode||""];
    case "priorityclasses": return [String(o.value ?? "")];
    default: return [];
  }
}

function render() {
  renderTabs();
  const kind = activeKind;
  document.getElementById("kindTitle").textContent = kind;
  document.getElementById("kindCount").textContent = store[kind].size + " objects";
  const head = ["name", ...COLS[kind], ""].map(c=>`<th>${esc(c)}</th>`).join("");
  document.querySelector("#resTable thead").innerHTML = `<tr>${head}</tr>`;
  const tb = document.querySelector("#resTable tbody"); tb.innerHTML = "";
  for (const [key, o] of [...store[kind].entries()].sort()) {
    const extra = cols(kind, o).map(v=>`<td>${esc(v)}</td>`).join("");
    const podAttr = kind === "pods" ? ` data-pod="${esc(key)}"` : "";
    const cls = kind === "pods" && !(o.spec||{}).nodeName ? ' class="pending"' : "";
    tb.insertAdjacentHTML("beforeend",
      `<tr${podAttr}${cls}><td>${esc(key)}</td>${extra}` +
      `<td><span class="edit" data-key="${esc(key)}">edit</span>` +
      `<span class="del" data-key="${esc(key)}">delete</span></td></tr>`);
  }
  // Handlers read dataset values — never inline JS with interpolated
  // strings (entity escaping is undone before the JS engine parses an
  // inline handler, which would turn a crafted resource name into
  // stored script injection).
  for (const el of document.querySelectorAll(".del"))
    el.onclick = (ev) => { ev.stopPropagation(); doDelete(el.dataset.key); };
  for (const el of document.querySelectorAll(".edit"))
    el.onclick = (ev) => { ev.stopPropagation(); showEdit(el.dataset.key); };
  for (const tr of document.querySelectorAll("tr[data-pod]"))
    tr.onclick = () => showResults(tr.dataset.pod);
  if (document.getElementById("boardPanel").style.display !== "none") renderBoard();
}

// -- pods-by-node board (web/store/pod.ts:12-16,43-51) ----------------------

// Permit-parked pods (assumed on their node but not bound yet): cached
// map refreshed with a single-in-flight fetch; renderBoard itself stays
// synchronous so overlapping watch chunks can't interleave stale
// responses over newer board states.
let waitingMap = new Map();
let waitingFetch = null;
function refreshWaiting() {
  if (waitingFetch) return;
  waitingFetch = fetch("/api/v1/waitingpods")
    .then(r => r.json())
    .then(out => {
      waitingMap = new Map(
        (out.items || []).map(w => [keyOf({metadata: w}), w.nodeName]));
      waitingFetch = null;
      renderBoardNow();
    })
    .catch(() => { waitingFetch = null; });
}

function renderBoard() {
  refreshWaiting();
  renderBoardNow();
}

function renderBoardNow() {
  const waiting = waitingMap;
  const buckets = new Map([["unscheduled", []]]);
  for (const name of [...store.nodes.keys()].sort()) buckets.set(name, []);
  for (const [key, p] of [...store.pods.entries()].sort()) {
    const node = (p.spec||{}).nodeName || waiting.get(key) || "unscheduled";
    if (!buckets.has(node)) buckets.set(node, []);
    buckets.get(node).push(key);
  }
  let html = "";
  for (const [node, podKeys] of buckets) {
    const cls = node === "unscheduled" ? "bucket unsched" : "bucket";
    html += `<div class="${cls}"><h3>${esc(node)} (${podKeys.length})</h3>` +
      podKeys.map(k=>{
        const tag = waiting.has(k) ? " ⏳" : "";
        return `<span class="bpod" data-pod="${esc(k)}">${esc(k)}${tag}</span>`;
      }).join("") +
      `</div>`;
  }
  const board = document.getElementById("board");
  board.innerHTML = html;
  for (const el of board.querySelectorAll(".bpod"))
    el.onclick = () => showResults(el.dataset.pod);
}

// -- scheduling results + history browser (SchedulingResults.vue) -----------

const RESULT_CATS = ["filter-result","score-result","finalscore-result","postfilter-result",
  "prefilter-result-status","prescore-result","reserve-result","permit-result",
  "permit-result-timeout","bind-result","selected-node"];

function categoryHTML(c, raw) {
  if (raw === undefined) return "";
  let body;
  try {
    const obj = JSON.parse(raw);
    if (c.endsWith("-result") && obj && typeof obj === "object" && !Array.isArray(obj)) {
      const nodesK = Object.keys(obj).sort();
      const plugins = [...new Set(nodesK.flatMap(n=>
        (obj[n] && typeof obj[n] === "object") ? Object.keys(obj[n]) : []))].sort();
      if (plugins.length && nodesK.every(n=>obj[n] && typeof obj[n] === "object")) {
        body = `<table><tr><th>node</th>${plugins.map(p=>`<th>${esc(p)}</th>`).join("")}</tr>` +
          nodesK.map(n=>`<tr><td>${esc(n)}</td>${plugins.map(pl=>`<td>${esc((obj[n]||{})[pl]??"")}</td>`).join("")}</tr>`).join("") +
          `</table>`;
      } else { body = `<pre>${esc(JSON.stringify(obj,null,1))}</pre>`; }
    } else { body = `<pre>${esc(JSON.stringify(obj,null,1))}</pre>`; }
  } catch (e) { body = `<pre>${esc(raw)}</pre>`; }
  return `<h2>${esc(c)}</h2>${body}`;
}

function showResults(key, attempt = -1) {
  selectedPod = key; selectedAttempt = attempt;
  const p = store.pods.get(key);
  if (!p) { document.getElementById("results").innerHTML = "none selected"; return; }
  const annos = ((p.metadata||{}).annotations)||{};
  let history = [];
  try { history = JSON.parse(annos[PREFIX+"result-history"] || "[]"); } catch (e) {}
  let html = `<b>${esc(key)}</b>`;
  // Attempt selector: the result-history annotation holds every past
  // attempt's full result set (storereflector.go:148-167).
  if (history.length > 1 || (history.length === 1 && attempt >= 0)) {
    html += `<div style="margin:.3rem 0">history: ` + history.map((_, i) =>
      `<span class="attempt ${i===attempt?"active":""}" data-attempt="${i}">#${i+1}</span>`
    ).join("") +
    `<span class="attempt ${attempt<0?"active":""}" data-attempt="-1">latest</span></div>`;
  }
  const source = attempt >= 0 && history[attempt]
    ? history[attempt]
    : annos;
  for (const c of RESULT_CATS) html += categoryHTML(c, source[PREFIX+c]);
  if (attempt < 0 && history.length)
    html += `<h2>attempts recorded</h2><pre>${esc(String(history.length))}</pre>`;
  const el = document.getElementById("results");
  el.innerHTML = html;
  for (const a of el.querySelectorAll(".attempt"))
    a.onclick = () => showResults(key, parseInt(a.dataset.attempt, 10));
}

// Per-kind last seen resourceVersion for reconnect-with-resume (the
// reference's RetryWatcher behavior on the client side).  The param map
// is interpolated from the server's single source of truth
// (ksim_tpu/server/params.py).
const LRV_PARAM = __LRV_PARAMS_JSON__;
const lastRV = {};

async function watch() {
  for (;;) {
    let resumed = false;
    try {
      const params = Object.entries(lastRV)
        .map(([k, rv]) => `${LRV_PARAM[k]}=${rv}`).join("&");
      const resp = await fetch("/api/v1/listwatchresources" + (params ? `?${params}` : ""));
      if (resp.status === 410) {
        // Compacted resume point: drop caches and relist from scratch.
        for (const k of KINDS) { store[k].clear(); delete lastRV[k]; }
        render();
        continue;
      }
      document.getElementById("status").textContent = "live";
      resumed = true;
      const reader = resp.body.getReader();
      const dec = new TextDecoder(); let buf = "";
      for (;;) {
        const {value, done} = await reader.read();
        if (done) break;
        buf += dec.decode(value, {stream: true});
        let i;
        while ((i = buf.indexOf("\\n")) >= 0) {
          const line = buf.slice(0, i); buf = buf.slice(i+1);
          if (!line.trim()) continue;
          const ev = JSON.parse(line);
          const map = store[ev.Kind]; if (!map) continue;
          const key = keyOf(ev.Obj);
          if (ev.EventType === "DELETED") map.delete(key); else map.set(key, ev.Obj);
          const rv = parseInt(((ev.Obj||{}).metadata||{}).resourceVersion, 10);
          if (!isNaN(rv)) lastRV[ev.Kind] = rv;
          if (ev.Kind === "pods" && key === selectedPod) showResults(key, selectedAttempt);
        }
        render();
      }
    } catch (e) { console.error("watch stream error", e); }
    document.getElementById("status").textContent = "reconnecting…";
    if (!resumed) {
      // Repeated failures without ever connecting: full refresh next try.
      for (const k of KINDS) { store[k].clear(); delete lastRV[k]; }
    }
    await new Promise(r => setTimeout(r, 1500));
  }
}

function resourcePath(kind, key) {
  const [a, b] = key.includes("/") ? key.split("/") : [null, key];
  return `/api/v1/resources/${kind}/` + (a ? `${a}/${b}` : b);
}
async function doDelete(key) {
  await fetch(resourcePath(activeKind, key), {method: "DELETE"});
}
function showAdd() {
  const t = document.getElementById("addText");
  t.value = JSON.stringify(TEMPLATES[activeKind], null, 1);
  document.getElementById("addPanel").style.display = "block";
  document.getElementById("addMsg").textContent = "";
}
async function doAdd() {
  const msg = document.getElementById("addMsg");
  try {
    // Paste-a-manifest workflow: JSON if it parses, otherwise the text
    // POSTs as YAML and the server parses it.
    const text = document.getElementById("addText").value;
    let body = text, ctype = "application/yaml";
    try { body = JSON.stringify(JSON.parse(text)); ctype = "application/json"; }
    catch (e) {}
    const r = await fetch(`/api/v1/resources/${activeKind}`, {
      method: "POST", headers: {"Content-Type": ctype}, body});
    msg.textContent = r.ok ? "created" : `error ${r.status}: ${await r.text()}`;
    if (r.ok) document.getElementById("addPanel").style.display = "none";
  } catch (e) { msg.textContent = String(e); }
}

// -- view/edit any live resource (the YamlEditor.vue workflow: YAML is
// the default editing format, server-side converted; JSON one click away) ---

let editTarget = null;  // {kind, key}
let editFmt = "yaml";

function fmtButtons(spanId, current, onPick) {
  const span = document.getElementById(spanId);
  span.innerHTML = ["yaml", "json"].map(f =>
    `<span class="tab ${f===current?"active":""}" data-fmt="${f}">${f}</span>`).join("");
  for (const el of span.querySelectorAll(".tab"))
    el.onclick = () => onPick(el.dataset.fmt);
}

async function showEdit(key, fmt, kindOverride) {
  // The format toggle re-invokes with the ORIGINAL kind: activeKind may
  // have moved to another tab while the edit panel stayed open.
  const kind = kindOverride || activeKind;
  editFmt = fmt || editFmt;
  const msg = document.getElementById("editMsg");
  try {
    const q = editFmt === "yaml" ? "?format=yaml" : "";
    const r = await fetch(resourcePath(kind, key) + q);
    if (!r.ok) { msg.textContent = `load failed: ${r.status}`; return; }
    editTarget = {kind, key};
    document.getElementById("editKey").textContent = `${kind}/${key}`;
    document.getElementById("editText").value = editFmt === "yaml"
      ? await r.text()
      : JSON.stringify(await r.json(), null, 1);
    fmtButtons("editFmtBtns", editFmt, f => {
      if (editTarget) showEdit(editTarget.key, f, editTarget.kind);
    });
    document.getElementById("editPanel").style.display = "block";
    msg.textContent = "";
  } catch (e) { msg.textContent = String(e); }
}
function hideEdit() {
  editTarget = null;
  document.getElementById("editPanel").style.display = "none";
}
async function doSave() {
  const msg = document.getElementById("editMsg");
  if (!editTarget) return;
  try {
    const text = document.getElementById("editText").value;
    let body = text, ctype = "application/yaml";
    if (editFmt === "json") {
      body = JSON.stringify(JSON.parse(text));
      ctype = "application/json";
    }
    const r = await fetch(resourcePath(editTarget.kind, editTarget.key), {
      method: "PUT", headers: {"Content-Type": ctype}, body});
    msg.textContent = r.ok ? "saved" : `rejected ${r.status}: ${await r.text()}`;
    if (r.ok) hideEdit();
  } catch (e) { msg.textContent = String(e); }
}

function toggle(id, onShow) {
  const el = document.getElementById(id);
  const show = el.style.display === "none";
  el.style.display = show ? "block" : "none";
  if (show && onShow) onShow();
}
let configFmt = "yaml";
async function loadConfig(fmt) {
  configFmt = fmt || configFmt;
  const q = configFmt === "yaml" ? "?format=yaml" : "";
  const r = await fetch("/api/v1/schedulerconfiguration" + q);
  document.getElementById("configText").value = configFmt === "yaml"
    ? await r.text()
    : JSON.stringify(await r.json(), null, 1);
  fmtButtons("configFmtBtns", configFmt, loadConfig);
  document.getElementById("configMsg").textContent = "";
}
async function applyConfig() {
  const msg = document.getElementById("configMsg");
  try {
    const text = document.getElementById("configText").value;
    let body = text, ctype = "application/yaml";
    if (configFmt === "json") {
      body = JSON.stringify(JSON.parse(text));
      ctype = "application/json";
    }
    const r = await fetch("/api/v1/schedulerconfiguration", {
      method: "POST", headers: {"Content-Type": ctype}, body});
    msg.textContent = r.ok ? "applied (kernel set recompiled)" : `rejected ${r.status}: ${await r.text()}`;
  } catch (e) { msg.textContent = String(e); }
}
async function loadMetrics() {
  const r = await fetch("/api/v1/metrics");
  document.getElementById("metricsPre").textContent = JSON.stringify(await r.json(), null, 1);
}

async function doExport() {
  const r = await fetch("/api/v1/export");
  const blob = await r.blob();
  const a = document.createElement("a");
  a.href = URL.createObjectURL(blob); a.download = "snapshot.json"; a.click();
}
async function doImport(input) {
  const file = input.files[0]; if (!file) return;
  await fetch("/api/v1/import", {method: "POST", body: await file.text(),
    headers: {"Content-Type": "application/json"}});
  input.value = "";
}
async function doReset() {
  await fetch("/api/v1/reset", {method: "PUT"});
  for (const k of KINDS) store[k].clear();
  render();
}
render();
watch();
</script>
</body>
</html>
"""

import json as _json

from ksim_tpu_torch.server.params import LRV_PARAMS as _LRV_PARAMS

INDEX_HTML = INDEX_HTML.replace("__LRV_PARAMS_JSON__", _json.dumps(_LRV_PARAMS))
