"""Embedded ops console (single page, zero build step).

Reference equivalent: the manager's embedded JS console
(manager/manager.go:62 ``//go:embed dist/*`` — an SPA built at CI time and
EMPTY in the reference snapshot). Here the console is one self-contained
HTML page served at ``/`` that reads the REST API the ops tooling already
uses: cluster/scheduler/seed-peer registry, applications, models, jobs, and
buckets, with a token box for auth-enabled managers. No framework, no
bundler — it ships with the package and works against any manager.

The port of dragonfly2_tpu/manager/console.py: the same page.
"""

CONSOLE_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>dragonfly2-tpu manager</title>
<style>
  :root { color-scheme: light dark; }
  body { font: 14px/1.5 system-ui, sans-serif; margin: 2rem auto; max-width: 70rem;
         padding: 0 1rem; }
  h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 1.8rem; }
  table { border-collapse: collapse; width: 100%; margin: .4rem 0 1rem; }
  th, td { text-align: left; padding: .25rem .6rem; border-bottom: 1px solid
           color-mix(in srgb, currentColor 18%, transparent); }
  th { font-weight: 600; }
  .muted { opacity: .6; } .err { color: #c0392b; }
  input { font: inherit; padding: .2rem .4rem; width: 24rem; max-width: 60vw; }
  button { font: inherit; padding: .2rem .8rem; }
  code { font-size: .85em; }
</style>
</head>
<body>
<h1>dragonfly2-tpu manager</h1>
<p class="muted">Live view of the cluster registry. Paste a bearer token if this
manager runs with auth (<code>POST /api/v1/users/signin</code> returns one).</p>
<p><input id="token" placeholder="bearer token (optional)" type="password">
   <button onclick="refresh()">refresh</button>
   <span id="status" class="muted"></span></p>
<div id="sections"></div>
<script>
const SECTIONS = [
  ["Scheduler clusters", "/api/v1/scheduler-clusters", ["id", "name", "is_default"]],
  ["Schedulers", "/api/v1/schedulers", ["id", "hostname", "ip", "port", "state", "scheduler_cluster_id"]],
  ["Seed peers", "/api/v1/seed-peers", ["id", "hostname", "ip", "port", "state"]],
  ["Applications", "/api/v1/applications", ["id", "name", "url", "bio"]],
  ["Models", "/api/v1/models", ["id", "type", "version", "state", "scheduler_id"]],
  ["OAuth providers", "/api/v1/oauth", ["id", "name", "auth_url"]],
  ["Buckets", "/api/v1/buckets", ["name", "created_at"]],
];
async function fetchJson(path) {
  const headers = {};
  const tok = document.getElementById("token").value.trim();
  if (tok) headers["Authorization"] = "Bearer " + tok;
  const resp = await fetch(path, { headers });
  const body = await resp.json().catch(() => null);
  if (!resp.ok) throw new Error((body && body.error) || ("HTTP " + resp.status));
  return body;
}
function render(title, rows, cols) {
  const h = ["<h2>" + title + "</h2>"];
  if (!Array.isArray(rows) || rows.length === 0) {
    h.push('<p class="muted">none</p>');
    return h.join("");
  }
  h.push("<table><tr>" + cols.map(c => "<th>" + c + "</th>").join("") + "</tr>");
  for (const r of rows) {
    h.push("<tr>" + cols.map(c => "<td>" + escapeHtml(r[c]) + "</td>").join("") + "</tr>");
  }
  h.push("</table>");
  return h.join("");
}
function escapeHtml(v) {
  if (v === undefined || v === null) return "";
  return String(v).replace(/[&<>"']/g, ch => (
    {"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[ch]));
}
async function refresh() {
  const status = document.getElementById("status");
  const out = [];
  status.textContent = "loading\\u2026";
  for (const [title, path, cols] of SECTIONS) {
    try {
      out.push(render(title, await fetchJson(path), cols));
    } catch (e) {
      out.push("<h2>" + title + '</h2><p class="err">' + escapeHtml(e.message) + "</p>");
    }
  }
  document.getElementById("sections").innerHTML = out.join("");
  status.textContent = "updated " + new Date().toLocaleTimeString();
}
refresh();
</script>
</body>
</html>
"""
