"""The run dashboard served at `/` and `/ui`: an own copy of
`polyaxon_tpu/streams/ui.py`, one static page of plain JavaScript over the
JSON routes of `streams/server.py`: runs by project, status, spec,
events, metrics as sparklines, logs followed by offset, artifacts, and
stop. Every string from the server is escaped."""

INDEX_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>polyaxon-tpu</title>
<style>
  body { font-family: ui-monospace, SFMono-Regular, Menlo, monospace;
         margin: 2rem; background: #0b0e14; color: #d6d6d6; }
  h1 { font-size: 1.1rem; letter-spacing: .06em; }
  h1 span { color: #7aa2f7; }
  h2 { font-size: .85rem; color: #8089a6; text-transform: uppercase;
       letter-spacing: .08em; margin: 1.2rem 0 .4rem; }
  table { border-collapse: collapse; width: 100%; margin-top: .4rem; }
  th, td { text-align: left; padding: .35rem .8rem; border-bottom: 1px solid #1f2430; }
  th { color: #8089a6; font-weight: 600; font-size: .8rem; text-transform: uppercase; }
  #runs tr:hover td { background: #11151f; cursor: pointer; }
  tr.sel td { background: #151b28; }
  .succeeded { color: #9ece6a; } .failed { color: #f7768e; }
  .running, .starting { color: #7aa2f7; } .stopped, .stopping { color: #e0af68; }
  .queued, .scheduled, .compiled, .created, .retrying { color: #8089a6; }
  #detail { margin-top: 1.5rem; border-top: 2px solid #1f2430; padding-top: 1rem; }
  pre { background: #11151f; padding: .8rem; overflow-x: auto; max-height: 18rem;
        white-space: pre-wrap; }
  .uuid { color: #565f89; }
  .muted { color: #565f89; font-size: .8rem; }
  .charts { display: flex; flex-wrap: wrap; gap: 1rem; }
  .chart { background: #11151f; padding: .6rem .8rem; border-radius: 4px; }
  .chart .k { color: #8089a6; font-size: .75rem; }
  .chart .v { color: #7aa2f7; font-size: .9rem; }
  svg polyline { fill: none; stroke: #7aa2f7; stroke-width: 1.5; }
  button { background: #1f2430; color: #f7768e; border: 1px solid #2a3040;
           font: inherit; padding: .25rem .9rem; cursor: pointer; border-radius: 3px; }
  button:hover { background: #2a3040; }
  input { background: #11151f; color: #d6d6d6; border: 1px solid #1f2430;
          font: inherit; padding: .25rem .5rem; }
  a { color: #7aa2f7; }
  .cols { display: flex; gap: 2rem; flex-wrap: wrap; }
  .cols > div { flex: 1 1 22rem; min-width: 0; }
</style>
</head>
<body>
<h1><span>polyaxon-tpu</span> runs
  <input id="proj" placeholder="project filter" size="14">
  <span class="muted" id="ts"></span></h1>
<table id="runs"><thead>
<tr><th>run</th><th>name</th><th>project</th><th>status</th></tr>
</thead><tbody></tbody></table>

<div id="detail" hidden>
  <h1 id="d-title"></h1>
  <div id="d-actions"></div>
  <h2>metrics</h2>
  <div class="charts" id="charts"></div>
  <table id="metrics"><thead></thead><tbody></tbody></table>
  <div class="cols">
    <div>
      <h2>params</h2>
      <pre id="params"></pre>
      <h2>conditions</h2>
      <table id="conds"><thead>
        <tr><th>status</th><th>reason</th><th>at</th></tr>
      </thead><tbody></tbody></table>
    </div>
    <div>
      <h2>artifacts</h2>
      <div id="artifacts" class="muted"></div>
      <h2>events</h2>
      <pre id="events"></pre>
    </div>
  </div>
  <h2>logs <span class="muted">(follows)</span></h2>
  <pre id="logs"></pre>
</div>

<script>
let selected = null;
let logOffset = 0;
async function j(p) { const r = await fetch(p); return r.json(); }
function esc(v) {  // all server strings are untrusted (run names from specs)
  return String(v ?? "").replace(/[&<>"']/g,
    c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));
}
function fmt(v) { return typeof v === "number" ? v.toPrecision(5) : esc(v); }

function sparkline(pts, w = 180, h = 44) {
  // pts: [[step, value], ...] -> inline SVG polyline, autoscaled
  if (pts.length < 2) return "";
  const xs = pts.map(p => p[0]), ys = pts.map(p => p[1]);
  const x0 = Math.min(...xs), x1 = Math.max(...xs);
  const y0 = Math.min(...ys), y1 = Math.max(...ys);
  const sx = v => x1 === x0 ? 0 : (v - x0) / (x1 - x0) * (w - 4) + 2;
  const sy = v => y1 === y0 ? h / 2 : h - 3 - (v - y0) / (y1 - y0) * (h - 6);
  const path = pts.map(p => `${sx(p[0]).toFixed(1)},${sy(p[1]).toFixed(1)}`).join(" ");
  return `<svg width="${w}" height="${h}"><polyline points="${path}"/></svg>`;
}

async function refresh() {
  const proj = document.getElementById("proj").value.trim();
  const runs = await j("/runs" + (proj ? `?project=${encodeURIComponent(proj)}` : ""));
  const tb = document.querySelector("#runs tbody");
  tb.innerHTML = "";
  for (const r of runs) {
    const tr = document.createElement("tr");
    if (r.uuid === selected) tr.className = "sel";
    tr.innerHTML = `<td class="uuid">${esc(r.uuid).slice(0,8)}</td>` +
      `<td>${esc(r.name)}</td><td>${esc(r.project)}</td>` +
      `<td class="${esc(r.status)}">${esc(r.status)}</td>`;
    tr.onclick = () => { selected = r.uuid; logOffset = 0; tick = 0;
                         document.getElementById("logs").textContent = "";
                         detail(); };
    tb.appendChild(tr);
  }
  document.getElementById("ts").textContent = new Date().toLocaleTimeString();
  if (selected) detail();
}

// stoppable = anything not terminal (mirrors lifecycle.DONE_STATUSES)
const DONE = new Set(["succeeded","failed","upstream_failed","stopped","skipped","done"]);
let tick = 0;

async function detail() {
  const d = document.getElementById("detail");
  d.hidden = false;
  const uuid = selected;
  const heavy = (tick++ % 10) === 0;  // spec/events/artifacts: selection +
                                      // every 10th poll, not every 3 s
  const [status, metrics, spec, events, arts] = await Promise.all([
    j(`/runs/${uuid}/status`), j(`/runs/${uuid}/metrics?tail=400`),
    heavy ? j(`/runs/${uuid}/spec`) : null,
    heavy ? j(`/runs/${uuid}/events`) : null,
    heavy ? j(`/runs/${uuid}/artifacts`) : null]);
  if (uuid !== selected) return;  // user clicked away mid-fetch
  document.getElementById("d-title").innerHTML =
    `<span class="uuid">${esc(uuid).slice(0,8)}</span> — ` +
    `<span class="${esc(status.status)}">${esc(status.status)}</span>`;

  // stop button for any non-terminal run
  const act = document.getElementById("d-actions");
  if (!DONE.has(status.status)) {
    act.innerHTML = `<button id="stopbtn">stop run</button>`;
    document.getElementById("stopbtn").onclick = async () => {
      await fetch(`/runs/${uuid}/stop`, {method: "POST"});
      refresh();
    };
  } else { act.innerHTML = ""; }

  // sparkline per numeric metric key; training keys first so sys.* monitor
  // counters can't crowd loss curves out of the 8-chart cap
  const keys = new Set();
  for (const m of metrics) for (const k of Object.keys(m))
    if (k !== "step" && k !== "ts" && typeof m[k] === "number") keys.add(k);
  const ordered = [...keys].sort((a, b) =>
    (a.startsWith("sys.") - b.startsWith("sys.")) || a.localeCompare(b));
  const charts = document.getElementById("charts");
  charts.innerHTML = "";
  for (const k of ordered.slice(0, 8)) {
    const pts = metrics.filter(m => typeof m[k] === "number")
                       .map(m => [m.step ?? 0, m[k]]);
    if (!pts.length) continue;
    const last = pts[pts.length - 1][1];
    const div = document.createElement("div");
    div.className = "chart";
    div.innerHTML = `<div class="k">${esc(k)}</div>` + sparkline(pts) +
      `<div class="v">${fmt(last)}</div>`;
    charts.appendChild(div);
  }

  const last = metrics.slice(-8);
  const mkeys = last.length ? Object.keys(last[0]).filter(k => k !== "ts") : [];
  document.querySelector("#metrics thead").innerHTML =
    "<tr>" + mkeys.map(k => `<th>${esc(k)}</th>`).join("") + "</tr>";
  document.querySelector("#metrics tbody").innerHTML = last.map(m =>
    "<tr>" + mkeys.map(k => `<td>${fmt(m[k])}</td>`).join("") + "</tr>").join("");

  if (spec) document.getElementById("params").textContent =
    JSON.stringify(spec.params ?? {}, null, 1);
  document.querySelector("#conds tbody").innerHTML =
    (status.conditions ?? []).slice(-10).map(c =>
      `<tr><td class="${esc(c.type)}">${esc(c.type)}</td>` +
      `<td>${esc(c.reason ?? "")}</td>` +
      `<td class="muted">${c.ts ? new Date(c.ts * 1000).toLocaleTimeString() : ""}</td></tr>`).join("");

  if (arts) {
    const files = (arts.files ?? []).slice(0, 40);
    document.getElementById("artifacts").innerHTML = files.length
      ? files.map(f => {
          const href = `/runs/${encodeURIComponent(uuid)}/artifacts/` +
            f.split("/").map(encodeURIComponent).join("/");
          return `<a href="${esc(href)}" download>${esc(f)}</a>`;
        }).join("<br>")
      : "none";
  }

  if (events) document.getElementById("events").textContent =
    (events ?? []).slice(-6).map(e => {
      const {kind, ts, ...rest} = e;
      const at = ts ? new Date(ts * 1000).toLocaleTimeString() : "";
      return `${at} ${kind}: ${JSON.stringify(rest)}`;
    }).join("\\n");

  // incremental log follow: only fetch what's new; compare-and-swap on
  // the offset so overlapping detail() calls never append a chunk twice
  const off = logOffset;
  const lg = await j(`/runs/${uuid}/logs?offset=${off}`);
  if (uuid !== selected || off !== logOffset) return;
  if (lg.logs) {
    const el = document.getElementById("logs");
    el.textContent = (el.textContent + lg.logs).split("\\n").slice(-200).join("\\n");
    el.scrollTop = el.scrollHeight;
  }
  logOffset = lg.offset ?? logOffset;
}
document.getElementById("proj").oninput = () => refresh();
refresh();
setInterval(refresh, 3000);
</script>
</body>
</html>
"""
