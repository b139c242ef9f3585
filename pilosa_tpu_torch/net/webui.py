"""Embedded web console.

The port's own copy of ``pilosa_tpu/net/webui.py``: ``GET /`` and
``GET /assets/<file>`` answer the same bytes on a port node.

A single-page admin console served from `/` — the counterpart of the
reference's statik-embedded WebUI (reference: webui/index.html,
webui/assets/main.js, handler.go:169-182), re-written from scratch with
the same feature surface:

* **Console pane** — a PQL REPL over POST /index/<i>/query with command
  history (Up/Down, preserving the edit buffer), Enter-to-run
  (Shift+Enter for newline), Tab completion of PQL keywords plus
  schema-derived index/frame names, per-result cards (input, source,
  status, latency, pretty JSON), and getting-started hints on
  index/frame-not-found errors.
* **Meta commands** — ``:create index <name> [opt=v ...]``,
  ``:create frame <name> [opt=v ...]``, ``:delete index|frame <name>``,
  ``:use <index>``, ``:help`` — driving the REST schema endpoints
  (reference: parse_query/parse_options in webui/assets/main.js).
* **Cluster pane** — node table (host, state) from /status and a
  per-index schema browser (frames with rowLabel / cacheType /
  cacheSize / inverseEnabled / timeQuantum) with hash-based tab
  routing (#console / #cluster).
"""

INDEX_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>pilosa-tpu console</title>
<link rel="stylesheet" href="/assets/main.css">
</head>
<body>
<header>
  <h1>pilosa-tpu</h1>
  <nav>
    <a id="nav-console" href="#console" class="nav-active">Console</a>
    <a id="nav-cluster" href="#cluster">Cluster</a>
  </nav>
  <span id="version" title="server version"></span>
</header>

<main>
  <section id="pane-console" class="pane pane-active">
    <div class="row">
      <label for="index-dropdown">index</label>
      <select id="index-dropdown"></select>
      <button id="run" title="Enter">Run &#9654;</button>
    </div>
    <textarea id="query" rows="3" spellcheck="false"
      placeholder="Count(Bitmap(frame='f', rowID=1))   &mdash;   :help for meta commands"></textarea>
    <div id="complete-hint"></div>
    <div id="outputs"></div>
  </section>

  <section id="pane-cluster" class="pane">
    <h2>Nodes</h2>
    <div id="status-nodes"></div>
    <h2>Schema</h2>
    <div id="status-indexes"></div>
  </section>
</main>
<script src="/assets/main.js"></script>
</body>
</html>
"""

MAIN_JS = """'use strict';

/* ---------------------------------------------------------------- utils */

const $ = (id) => document.getElementById(id);

function getJSON(url) {
  return fetch(url).then((r) => r.json());
}

function esc(s) {
  const d = document.createElement('div');
  d.textContent = String(s);
  return d.innerHTML;
}

function prettyMaybeJSON(text) {
  try { return JSON.stringify(JSON.parse(text), null, 2); }
  catch (e) { return text; }
}

/* ------------------------------------------------------------ nav panes */

function activatePane(name) {
  document.querySelectorAll('nav a').forEach((a) =>
    a.classList.toggle('nav-active', a.id === 'nav-' + name));
  document.querySelectorAll('.pane').forEach((p) =>
    p.classList.toggle('pane-active', p.id === 'pane-' + name));
  if (name === 'cluster') refreshCluster();
}

window.addEventListener('hashchange', () => {
  const name = window.location.hash.substring(1);
  if (name === 'console' || name === 'cluster') activatePane(name);
});

/* -------------------------------------------------------- cluster pane */

function tableOf(caption, headers, rows) {
  const h = headers.map((x) => `<th>${esc(x)}</th>`).join('');
  const body = rows.map((r) =>
    '<tr>' + r.map((c) => `<td>${esc(c)}</td>`).join('') + '</tr>').join('');
  return `<table><caption>${esc(caption)}</caption>` +
         `<tr>${h}</tr>${body}</table>`;
}

function refreshCluster() {
  getJSON('/status').then((s) => {
    const nodes = (s.status && s.status.Nodes) || [];
    $('status-nodes').innerHTML = tableOf(
      `${nodes.length} node(s)`, ['Host', 'State'],
      nodes.map((n) => [n.Host, n.State]));
  }).catch(() => { $('status-nodes').textContent = 'status unavailable'; });
  getJSON('/schema').then((s) => {
    const div = $('status-indexes');
    const tables = (s.indexes || []).map((idx) => tableOf(
      `${idx.name} (columnLabel: ${idx.columnLabel}` +
        (idx.timeQuantum ? `, timeQuantum: ${idx.timeQuantum}` : '') + ')',
      ['Frame', 'Row Label', 'Cache Type', 'Cache Size', 'Inverse', 'Time Quantum'],
      (idx.frames || []).map((f) =>
        [f.name, f.rowLabel, f.cacheType, f.cacheSize,
         f.inverseEnabled, f.timeQuantum || '-'])));
    if (tables.length) div.innerHTML = tables.join('');
    else div.textContent = 'no indexes';
  }).catch(() => {});
}

/* -------------------------------------------------- schema + completion */

const PQL_KEYWORDS = [
  'SetBit()', 'ClearBit()', 'SetRowAttrs()', 'SetColumnAttrs()',
  'Bitmap()', 'Union()', 'Intersect()', 'Difference()', 'Xor()',
  'Count()', 'Range()', 'TopN()', 'frame=', 'rowID=', 'columnID=',
];
let dynamicKeywords = [];

function refreshSchema() {
  return getJSON('/schema').then((s) => {
    const sel = $('index-dropdown');
    const current = sel.value;
    sel.innerHTML = '';
    dynamicKeywords = [];
    (s.indexes || []).forEach((idx) => {
      const opt = document.createElement('option');
      opt.value = opt.textContent = idx.name;
      sel.appendChild(opt);
      dynamicKeywords.push(idx.name);
      (idx.frames || []).forEach((f) => dynamicKeywords.push(f.name));
    });
    if (current) sel.value = current;
  }).catch(() => {});
}

function completeAtCursor(input) {
  // The word fragment runs from the last non-alphanumeric character
  // before the cursor to the cursor.
  const pos = input.selectionEnd;
  let start = pos;
  while (start > 0 && /[A-Za-z0-9_]/.test(input.value[start - 1])) start--;
  const frag = input.value.substring(start, pos);
  if (!frag) return;
  const all = PQL_KEYWORDS.concat(dynamicKeywords);
  const matches = all.filter((k) => k.startsWith(frag) && k !== frag);
  const hint = $('complete-hint');
  if (matches.length === 1) {
    const add = matches[0].substring(frag.length);
    input.value = input.value.substring(0, pos) + add + input.value.substring(pos);
    // land inside the parens of keyword() completions
    const newPos = pos + add.length - (matches[0].endsWith(')') ? 1 : 0);
    input.setSelectionRange(newPos, newPos);
    hint.textContent = '';
  } else {
    hint.textContent = matches.length ? matches.join('   ') : '';
  }
}

/* ------------------------------------------------------- meta commands */

const HELP_TEXT = [
  ':create index <name> [columnLabel=x] [timeQuantum=YMDH]',
  ':create frame <name> [rowLabel=x] [cacheType=ranked|lru] ' +
    '[cacheSize=n] [inverseEnabled=true] [timeQuantum=YMDH]',
  ':delete index <name>',
  ':delete frame <name>',
  ':use <index>',
  ':help',
].join('\\n');

function parseOptions(parts) {
  const ints = ['cacheSize'];
  const bools = ['inverseEnabled'];
  const out = {};
  parts.forEach((p) => {
    const [k, v] = p.split('=');
    if (!k || v === undefined) return;
    if (ints.includes(k)) out[k] = Number(v);
    else if (bools.includes(k)) out[k] = v === 'true';
    else out[k] = v;
  });
  return out;
}

// :command -> {url, method, body} | {use: name} | {help: true} | null
function parseMeta(query, indexName) {
  const parts = query.trim().replace(/\\s+/g, ' ').split(' ');
  const cmd = parts[0];
  if (cmd === ':help') return { help: true };
  if (cmd === ':use') return parts[1] ? { use: parts[1] } : null;
  const kind = parts[1], name = parts[2];
  if (!name) return null;
  const url = kind === 'index' ? `/index/${encodeURIComponent(name)}`
    : kind === 'frame'
      ? `/index/${encodeURIComponent(indexName)}/frame/${encodeURIComponent(name)}`
      : null;
  if (url === null) return null;
  if (cmd === ':create') {
    const opts = parseOptions(parts.slice(3));
    return {
      url, method: 'POST',
      body: Object.keys(opts).length ? JSON.stringify({ options: opts }) : '',
    };
  }
  if (cmd === ':delete') return { url, method: 'DELETE', body: '' };
  return null;
}

/* ---------------------------------------------------------------- REPL */

const GETTING_STARTED = [
  'Just getting started?  Try:',
  '  :create index test',
  '  :use test',
  '  :create frame foo',
  "  SetBit(frame='foo', rowID=0, columnID=0)",
].join('\\n');

class Repl {
  constructor(input, outputs) {
    this.input = input;
    this.outputs = outputs;
    this.history = [];
    this.cursor = 0;      // index into history while browsing
    this.stash = '';      // the in-progress edit, restored on Down
  }

  historyUp() {
    if (this.cursor === 0) return;
    if (this.cursor === this.history.length) this.stash = this.input.value;
    this.cursor--;
    this.setValue(this.history[this.cursor]);
  }

  historyDown() {
    if (this.cursor === this.history.length) return;
    this.cursor++;
    this.setValue(this.cursor === this.history.length
      ? this.stash : this.history[this.cursor]);
  }

  setValue(v) {
    this.input.value = v;
    this.input.setSelectionRange(v.length, v.length);
  }

  submit() {
    const query = this.input.value.trim();
    if (!query) return;
    this.history.push(query);
    this.cursor = this.history.length;
    this.stash = '';
    this.input.value = '';
    this.run(query);
  }

  run(query) {
    const indexName = $('index-dropdown').value;
    if (query.startsWith(':')) {
      const meta = parseMeta(query, indexName);
      if (meta === null) {
        this.card(query, indexName, 'invalid meta command\\n' + HELP_TEXT, 400, 0);
      } else if (meta.help) {
        this.card(query, indexName, HELP_TEXT, 200, 0);
      } else if (meta.use) {
        const sel = $('index-dropdown');
        const known = Array.from(sel.options).some((o) => o.value === meta.use);
        if (known) {
          sel.value = meta.use;
          this.card(query, meta.use, 'using ' + meta.use, 200, 0);
        } else {
          this.card(query, indexName, 'no such index: ' + meta.use, 404, 0);
        }
      } else {
        this.request(query, indexName, meta.url, meta.method, meta.body)
          .then(refreshSchema);
      }
      return;
    }
    this.request(query, indexName,
                 `/index/${encodeURIComponent(indexName)}/query`, 'POST', query);
  }

  request(query, indexName, url, method, body) {
    const t0 = performance.now();
    return fetch(url, { method, body }).then((r) =>
      r.text().then((text) => {
        this.card(query, indexName, text, r.status,
                  Math.round(performance.now() - t0));
      })
    ).catch((e) => {
      this.card(query, indexName, String(e), 0, 0);
    });
  }

  card(input, indexName, outputText, status, ms) {
    const err = status !== 200;
    let body = prettyMaybeJSON(outputText);
    if (err && /index not found|frame not found/.test(outputText)) {
      body += '\\n\\n' + GETTING_STARTED;
    }
    const node = document.createElement('div');
    node.className = 'card' + (err ? ' card-error' : '');
    node.innerHTML =
      `<div class="card-head"><span class="badge">${esc(indexName || '-')}` +
      `</span><code>${esc(input)}</code>` +
      `<em>${err ? 'http ' + status : ms + ' ms'}</em></div>` +
      `<pre>${esc(body)}</pre>`;
    this.outputs.insertBefore(node, this.outputs.firstChild);
  }
}

/* ---------------------------------------------------------------- init */

const repl = new Repl($('query'), $('outputs'));

$('query').addEventListener('keydown', (e) => {
  const atFirstLine =
    !$('query').value.substring(0, $('query').selectionStart).includes('\\n');
  const atLastLine =
    !$('query').value.substring($('query').selectionEnd).includes('\\n');
  if (e.key === 'Enter' && !e.shiftKey) {
    e.preventDefault();
    repl.submit();
  } else if (e.key === 'ArrowUp' && atFirstLine) {
    e.preventDefault();
    repl.historyUp();
  } else if (e.key === 'ArrowDown' && atLastLine) {
    e.preventDefault();
    repl.historyDown();
  } else if (e.key === 'Tab') {
    e.preventDefault();
    completeAtCursor($('query'));
  }
});

$('run').addEventListener('click', () => repl.submit());

getJSON('/version').then((v) => {
  $('version').textContent = 'v' + v.version;
}).catch(() => {});

refreshSchema().then(() => {
  const name = window.location.hash.substring(1);
  if (name === 'cluster') activatePane('cluster');
});
$('query').focus();
"""

MAIN_CSS = """body { font-family: monospace; margin: 0; background: #111;
  color: #dcdcdc; }
header { padding: 0.6rem 1rem; background: #222; display: flex;
  align-items: baseline; gap: 1.5rem; }
h1 { font-size: 1.1rem; margin: 0; color: #7fd4ff; }
h2 { font-size: 0.95rem; color: #9fe89f; }
nav { display: flex; gap: 1rem; }
nav a { color: #888; text-decoration: none; padding-bottom: 2px; }
nav a.nav-active { color: #dcdcdc; border-bottom: 2px solid #7fd4ff; }
#version { margin-left: auto; color: #666; }
main { padding: 1rem; max-width: 64rem; }
.pane { display: none; }
.pane-active { display: block; }
.row { display: flex; gap: 0.5rem; margin-bottom: 0.5rem;
  align-items: center; }
label { color: #888; }
select, input, textarea { background: #1b1b1b; color: #dcdcdc;
  border: 1px solid #333; padding: 0.4rem; font-family: inherit; }
textarea { width: 100%; box-sizing: border-box; }
button { background: #245; color: #cfe; border: 1px solid #368;
  padding: 0.4rem 1rem; cursor: pointer; }
button:hover { background: #356; }
#complete-hint { color: #887a33; min-height: 1.1rem;
  white-space: pre; overflow-x: auto; }
.card { border: 1px solid #333; margin: 0.6rem 0; background: #1b1b1b; }
.card-error { border-color: #844; }
.card-head { display: flex; gap: 0.8rem; align-items: baseline;
  padding: 0.3rem 0.6rem; background: #232323; }
.card-head em { margin-left: auto; color: #666; }
.card-error .card-head { background: #2a1a1a; }
.badge { background: #245; color: #cfe; padding: 0 0.4rem;
  border-radius: 2px; }
.card pre { margin: 0; padding: 0.6rem; max-height: 18rem;
  overflow: auto; }
pre { background: #1b1b1b; border: 0; }
table { border-collapse: collapse; margin: 0.6rem 0; }
caption { text-align: left; color: #9fe89f; padding-bottom: 0.2rem; }
th, td { border: 1px solid #333; padding: 0.25rem 0.6rem;
  text-align: left; }
th { background: #232323; }
"""

ASSETS = {
    "main.js": (MAIN_JS, "application/javascript"),
    "main.css": (MAIN_CSS, "text/css"),
}
