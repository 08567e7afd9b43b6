"""Training dashboard (reference ``UIServer`` web app) — self-contained
HTML with inline SVG charts: score vs iteration, update:param log-ratio
per layer, param mean magnitudes, and iteration timing. Two modes:
``render(path)`` writes a static file; ``start(port)`` serves it live over
HTTP (stdlib ThreadingHTTPServer — the role of the reference's Play/Vertx
server) with ``/train/stats.json``, a Prometheus ``/metrics`` scrape +
``/metrics.json``, ``/health``, ``/platform``, ``/slo``, ``/traces``,
``/analysis`` and auto-refresh, no JS dependencies.

Counterpart of the JAX package's ``ui/server.py``. ``/sharding`` lists the
live sharding plans (``sharding.plans_summary()``: each resolved
param-path -> PartitionSpec table), and the System tab renders them as the
"Sharding plans" panel."""

from __future__ import annotations

import html
from typing import Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.ui.stats import StatsStorage

_W, _H, _PAD = 640, 220, 40
_COLORS = ("#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e",
           "#8c564b", "#e377c2", "#7f7f7f")


def _polyline(xs: Sequence[float], ys: Sequence[float],
              xr: Tuple[float, float], yr: Tuple[float, float],
              color: str) -> str:
    if not xs:
        return ""
    x0, x1 = xr
    y0, y1 = yr
    sx = (_W - 2 * _PAD) / max(x1 - x0, 1e-12)
    sy = (_H - 2 * _PAD) / max(y1 - y0, 1e-12)
    pts = " ".join(
        f"{_PAD + (x - x0) * sx:.1f},{_H - _PAD - (y - y0) * sy:.1f}"
        for x, y in zip(xs, ys))
    return (f'<polyline fill="none" stroke="{color}" stroke-width="1.5" '
            f'points="{pts}"/>')


def _page(title: str, body: str, head_extra: str = "",
          style_extra: str = "") -> str:
    """Shared HTML shell for the dashboard and the arbiter search report
    (one place for charset/fonts/chart styling)."""
    return ("<!doctype html><html><head><meta charset='utf-8'>"
            f"{head_extra}<title>{html.escape(title)}</title><style>"
            "body{font-family:sans-serif;margin:24px;background:#fafafa}"
            ".chart{background:#fff;border:1px solid #ddd;margin:12px 0;"
            "padding:8px}h3{margin:4px 0}"
            f"{style_extra}</style></head><body>{body}</body></html>")


def _chart(title: str, series: Dict[str, Tuple[List[float], List[float]]],
           y_label: str = "") -> str:
    allx = [x for xs, _ in series.values() for x in xs]
    ally = [y for _, ys in series.values() for y in ys]
    if not allx:
        return ""
    xr = (min(allx), max(allx) or 1.0)
    ylo, yhi = min(ally), max(ally)
    if ylo == yhi:
        ylo, yhi = ylo - 1.0, yhi + 1.0
    yr = (ylo, yhi)
    lines, legend = [], []
    for i, (name, (xs, ys)) in enumerate(sorted(series.items())):
        c = _COLORS[i % len(_COLORS)]
        lines.append(_polyline(xs, ys, xr, yr, c))
        legend.append(f'<tspan fill="{c}">&#9632; {html.escape(name)} '
                      f'</tspan>')
    axis = (f'<line x1="{_PAD}" y1="{_H - _PAD}" x2="{_W - _PAD}" '
            f'y2="{_H - _PAD}" stroke="#999"/>'
            f'<line x1="{_PAD}" y1="{_PAD}" x2="{_PAD}" y2="{_H - _PAD}" '
            f'stroke="#999"/>'
            f'<text x="{_PAD}" y="{_H - 8}" font-size="10" fill="#666">'
            f'{xr[0]:.0f}</text>'
            f'<text x="{_W - _PAD}" y="{_H - 8}" font-size="10" '
            f'fill="#666" text-anchor="end">{xr[1]:.0f}</text>'
            f'<text x="{_PAD - 4}" y="{_H - _PAD}" font-size="10" '
            f'fill="#666" text-anchor="end">{yr[0]:.3g}</text>'
            f'<text x="{_PAD - 4}" y="{_PAD + 4}" font-size="10" '
            f'fill="#666" text-anchor="end">{yr[1]:.3g}</text>')
    return (f'<div class="chart"><h3>{html.escape(title)} '
            f'<small>{html.escape(y_label)}</small></h3>'
            f'<svg width="{_W}" height="{_H}">{axis}{"".join(lines)}'
            f'<text x="{_PAD}" y="14" font-size="11">{"".join(legend)}'
            f'</text></svg></div>')


_HW, _HH = 150, 90


def _hist_svg(h: dict, color: str) -> str:
    """One small-multiple histogram: bars over [min, max]."""
    counts = h.get("counts") or []
    peak = max(counts, default=0) or 1
    n = len(counts)
    bw = (_HW - 8) / max(n, 1)
    bars = "".join(
        f'<rect x="{4 + i * bw:.1f}" '
        f'y="{_HH - 18 - (c / peak) * (_HH - 26):.1f}" '
        f'width="{max(bw - 1, 1):.1f}" '
        f'height="{(c / peak) * (_HH - 26):.1f}" fill="{color}"/>'
        for i, c in enumerate(counts))
    return (f'<svg width="{_HW}" height="{_HH}">{bars}'
            f'<text x="4" y="{_HH - 4}" font-size="9" fill="#666">'
            f'{h.get("min", 0):.2g}</text>'
            f'<text x="{_HW - 4}" y="{_HH - 4}" font-size="9" fill="#666" '
            f'text-anchor="end">{h.get("max", 0):.2g}</text></svg>')


def _hist_panel(title: str, per_layer: dict, color: str) -> str:
    """Latest per-layer histograms as a row of small multiples (reference
    dashboard: parameter/update/activation/gradient histogram panels)."""
    if not per_layer:
        return ""
    cells = "".join(
        f'<div style="display:inline-block;margin:4px;text-align:center">'
        f'<div style="font-size:11px">{html.escape(str(layer))}</div>'
        f'{_hist_svg(h, color)}</div>'
        for layer, h in sorted(per_layer.items()))
    return (f'<div class="chart"><h3>{html.escape(title)}</h3>{cells}'
            f'</div>')


class UIServer:
    """Reference ``UIServer#getInstance().attach(storage)`` — here a
    renderer over the same storage."""

    _instance: Optional["UIServer"] = None

    def __init__(self):
        import threading

        self._storages: List[StatsStorage] = []
        self._remote_storage: Optional[StatsStorage] = None
        self._remote_lock = threading.Lock()

    @classmethod
    def get_instance(cls) -> "UIServer":
        if cls._instance is None:
            cls._instance = UIServer()
        return cls._instance

    def attach(self, storage: StatsStorage):
        if storage not in self._storages:
            self._storages.append(storage)
        return self

    def detach(self, storage: StatsStorage):
        if storage in self._storages:
            self._storages.remove(storage)
        return self

    def render(self, path: str) -> str:
        """Write the dashboard HTML; returns the path."""
        with open(path, "w") as f:
            f.write(self.render_html())
        return path

    def start(self, port: int = 9000, host: str = "127.0.0.1",
              max_body_bytes: int = 8 * 1024 * 1024) -> int:
        """Serve the dashboard live (reference ``UIServer`` web server).
        ``port=0`` picks a free port; returns the bound port. Endpoints:
        ``/`` (auto-refreshing dashboard), ``/train/stats.json`` (raw
        records). ``host`` defaults to loopback; bind ``"0.0.0.0"`` to
        receive cross-machine ``RemoteUIStatsStorageRouter`` posts (the
        reference's remote-router deployment). POST bodies above
        ``max_body_bytes`` are rejected with 413 before being read."""
        import http.server
        import json as _json
        import threading

        if getattr(self, "_httpd", None) is not None:
            return self._httpd.server_address[1]
        ui = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path in ("/", "/train", "/train/overview"):
                    payload = ui.render_html(refresh_seconds=5).encode()
                    ctype = "text/html; charset=utf-8"
                elif self.path == "/train/stats.json":
                    recs = [r for st in ui._storages for r in st.records()]
                    payload = _json.dumps(recs).encode()
                    ctype = "application/json"
                elif self.path == "/metrics":
                    # Prometheus text exposition: registry metrics +
                    # span phase summaries (telemetry subsystem)
                    from deeplearning4j_tpu_torch import telemetry

                    payload = telemetry.prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path == "/metrics.json":
                    from deeplearning4j_tpu_torch import telemetry

                    payload = _json.dumps(
                        telemetry.telemetry_record()).encode()
                    ctype = "application/json"
                elif self.path == "/sharding":
                    # live sharding plans (sharding.plan registry): the
                    # resolved param-path -> PartitionSpec tables as JSON,
                    # the scriptable twin of the System-tab panel
                    from deeplearning4j_tpu_torch.sharding import (
                        plans_summary,
                    )

                    payload = _json.dumps(plans_summary()).encode()
                    ctype = "application/json"
                elif self.path == "/platform":
                    # live multi-tenant serving platforms
                    # (parallel.platform registry): per-model version,
                    # queue, breaker, canary + last-rollback records,
                    # warmup-budget spend — the scriptable twin of the
                    # "Serving platform" panel
                    from deeplearning4j_tpu_torch.parallel.platform import (
                        platforms_summary,
                    )

                    payload = _json.dumps(platforms_summary()).encode()
                    ctype = "application/json"
                elif self.path == "/analysis":
                    # program-lint findings accumulated by this process
                    # (analysis.findings.LOG), plus per-(rule, severity)
                    # totals — the scriptable twin of
                    # dl4j_analysis_findings_total
                    from deeplearning4j_tpu_torch.analysis.findings import LOG

                    payload = _json.dumps(LOG.snapshot()).encode()
                    ctype = "application/json"
                elif self.path == "/traces":
                    # retained request traces (telemetry.tracing): the
                    # tail-sampled ring + sampler counters — the
                    # scriptable twin of the flight-recorder bundle's
                    # traces.json
                    from deeplearning4j_tpu_torch.telemetry import (
                        flightrec,
                        tracing,
                    )

                    payload = _json.dumps(flightrec.sanitize_json(
                        tracing.snapshot())).encode()
                    ctype = "application/json"
                elif self.path == "/slo":
                    # burn-rate alert states over every live SLO monitor
                    # (telemetry.slo): per-tenant state, burn rates and
                    # the full transition history with request indices
                    from deeplearning4j_tpu_torch.telemetry import slo

                    payload = _json.dumps(slo.status()).encode()
                    ctype = "application/json"
                elif self.path == "/health":
                    # training-health probe (telemetry.health): policy,
                    # anomaly counts, last guard readings — the liveness/
                    # readiness surface a production trainer is scraped
                    # on. Sanitized: the report carries non-finite floats
                    # exactly when it matters, and a bare NaN literal is
                    # invalid JSON to strict scrape agents. The resilience
                    # block adds every live circuit breaker's state plus
                    # the retry/resume/fault-injection counters.
                    from deeplearning4j_tpu_torch import resilience
                    from deeplearning4j_tpu_torch.telemetry import (
                        flightrec,
                        health,
                    )

                    report = dict(health.report())
                    report["resilience"] = resilience.status()
                    payload = _json.dumps(
                        flightrec.sanitize_json(report)).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_POST(self):
                # remote stats intake (reference RemoteUIStatsStorageRouter
                # -> UIServer remote listening): workers POST records here
                if self.path != "/train/post":
                    self.send_response(404)
                    self.end_headers()
                    return
                length = int(self.headers.get("Content-Length", 0))
                if length < 0 or length > max_body_bytes:
                    # one oversized post (or a negative length turning
                    # read() unbounded) must not exhaust server memory
                    self.send_response(413)
                    self.end_headers()
                    return
                try:
                    record = _json.loads(self.rfile.read(length))
                except ValueError:
                    record = None
                if not isinstance(record, dict):
                    # a non-dict record would poison every later render
                    self.send_response(400)
                    self.end_headers()
                    return
                ui.remote_storage().put(record)
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass  # keep training logs clean

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self):
        httpd = getattr(self, "_httpd", None)
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            self._httpd = None
        return self

    def remote_storage(self) -> StatsStorage:
        """Auto-attached storage receiving POSTed records from
        ``RemoteUIStatsStorageRouter`` clients (lock-guarded: concurrent
        first POSTs from ThreadingHTTPServer handler threads must not race
        the lazy init)."""
        with self._remote_lock:
            if self._remote_storage is None:
                from deeplearning4j_tpu_torch.ui.stats import InMemoryStatsStorage

                self._remote_storage = InMemoryStatsStorage()
                self.attach(self._remote_storage)
            return self._remote_storage

    def _metric_table_panel(self, title: str, prefix: str) -> str:
        """One System-tab table of every registry series under
        ``prefix`` (scalars verbatim, histograms as count/mean/quantile
        summaries). Rendered only when the subsystem has actually
        produced a series in this process."""
        from deeplearning4j_tpu_torch.telemetry import REGISTRY

        snap = REGISTRY.snapshot(run_collectors=False)
        rows = []
        for key in sorted(snap):
            if not key.startswith(prefix):
                continue
            v = snap[key]
            if isinstance(v, dict):
                if not v.get("count"):
                    continue
                val = (f"count {v['count']}  mean {v['mean']:.4g}  "
                       f"p50 {v['p50']:.4g}  p95 {v['p95']:.4g}  "
                       f"p99 {v['p99']:.4g}")
            else:
                val = f"{v:.6g}"
            rows.append(f"<tr><td>{html.escape(key)}</td>"
                        f"<td>{html.escape(val)}</td></tr>")
        if not rows:
            return ""
        return (f'<div class="chart"><h3>{html.escape(title)}</h3>'
                '<table style="font-size:12px;border-spacing:8px 2px">'
                + "".join(rows) + "</table></div>")

    def _serving_panel(self) -> str:
        """Serving-engine metrics (parallel.batcher): requests by
        status, shared-launch counts, fill ratio and latency quantiles,
        queue depth."""
        return self._metric_table_panel("Serving (dynamic batcher)",
                                        "dl4j_serving_")

    def _generation_panel(self) -> str:
        """Continuous-batching generation metrics (parallel.generation):
        token counters, running-batch occupancy, KV-cache rows in use,
        per-token and time-to-first-token latency quantiles — next to
        the serving panel. The prefix-cache (``dl4j_prefix_*``: hits /
        misses / evictions / live pages / prefill tokens skipped) and
        speculative-decoding (``dl4j_spec_*``: per-window acceptance
        histogram, drafted vs accepted vs emitted counters) series
        render in the same panel when those features are on."""
        return (self._metric_table_panel("Generation (continuous batching)",
                                         "dl4j_decode_")
                + self._metric_table_panel("Generation — prefix cache",
                                           "dl4j_prefix_")
                + self._metric_table_panel("Generation — speculative decode",
                                           "dl4j_spec_"))

    def _platform_panel(self) -> str:
        """Multi-tenant serving platform (parallel.platform): one row
        per tenant — version, queue depth, breaker state, canary arm +
        gate records, warmup-budget spend — plus the ``dl4j_platform_*``
        lifecycle counters. Rendered only while a platform is live (or
        its counters have recorded)."""
        try:
            from deeplearning4j_tpu_torch.parallel.platform import (
                platforms_summary,
            )

            summaries = platforms_summary()
        except Exception:
            summaries = []
        rows = []
        for stats in summaries:
            for name, row in sorted(stats.items()):
                canary = row.get("canary")
                cell = (f"v{canary['version']} @ {canary['fraction']:.0%} "
                        f"({canary['breaker']})" if canary else "—")
                if canary and canary.get("accuracy_samples") is not None:
                    # accuracy arm live (quantized rollout): show the
                    # worst observed output delta vs the incumbent
                    cell += (f" Δmax {canary['accuracy_max_delta']:.2g}/"
                             f"{canary['accuracy_samples']}")
                last = row.get("last_rollback")
                rows.append(
                    f"<tr><td>{html.escape(name)}</td>"
                    f"<td>v{row.get('version', '?')}</td>"
                    f"<td>{row.get('queue_depth', 0)}</td>"
                    f"<td>{html.escape(str(row.get('breaker')))}</td>"
                    f"<td>{html.escape(cell)}</td>"
                    f"<td>{html.escape(last['reason']) if last else '—'}"
                    f"</td></tr>")
        table = ""
        if rows:
            table = ('<table style="font-size:12px;border-spacing:8px 2px">'
                     "<tr><th>model</th><th>version</th><th>queue</th>"
                     "<th>breaker</th><th>canary</th><th>last rollback</th>"
                     "</tr>" + "".join(rows) + "</table>")
        counters = (self._metric_table_panel("", "dl4j_platform_")
                    + self._metric_table_panel("", "dl4j_canary_"))
        if not table and not counters:
            return ""
        return ('<div class="chart"><h3>Serving platform '
                f'(multi-tenant)</h3>{table}{counters}</div>')

    def _slo_panel(self) -> str:
        """SLO burn-rate alerting (telemetry.slo): per-tenant alert
        state and short/long-window burn rates (``dl4j_slo_*``) plus the
        transition counter — rendered only once a monitor has recorded
        a transition or the collector has published a gauge."""
        return self._metric_table_panel("SLOs (burn rates)", "dl4j_slo_")

    def _sharding_panel(self) -> str:
        """Live sharding plans (sharding.plan registry): the resolved
        param-path -> PartitionSpec table (opt-state specs summarized), the
        System-tab view of "which tensor lives where". Rendered only when a
        plan has resolved in this process."""
        import json

        from deeplearning4j_tpu_torch.sharding import plans_summary

        summaries = plans_summary()
        if not summaries:
            return ""
        blocks = []
        for s in summaries:
            rows = "".join(
                f"<tr><td>{html.escape(r['path'])}</td>"
                f"<td>{html.escape('x'.join(map(str, r['shape'])) or 'scalar')}"
                f"</td><td>{html.escape(r['spec'])}"
                f"{' (demoted)' if r.get('demoted') else ''}</td></tr>"
                for r in s["params"])
            blocks.append(
                f"<h4>mesh {html.escape(json.dumps(s['mesh']))} · "
                f"{len(s['params'])} params · "
                f"{len(s['opt_state'])} opt buffers</h4>"
                '<table style="font-size:12px;border-spacing:8px 2px">'
                "<tr><th>param</th><th>shape</th><th>spec</th></tr>"
                + rows + "</table>")
        return ('<div class="chart"><h3>Sharding plans</h3>'
                + "".join(blocks) + "</div>")

    def _pod_panel(self) -> str:
        """Pod topology + distributed-snapshot metrics
        (resilience.pod): host count, per-host shard bytes, snapshot /
        restore duration quantiles, and the scoped resume counters —
        rendered only once a pod session has recorded a series."""
        return self._metric_table_panel("Pod (distributed snapshots)",
                                        "dl4j_pod_")

    def _kernels_panel(self) -> str:
        """The kernel registry (kernels/): tuned-selection counts by
        kernel and shape bucket, autotune trial/winner counters, tuning
        cache hit/entry gauges — rendered only once the registry has
        routed or tuned something in this process."""
        return self._metric_table_panel("Kernels (autotuner)",
                                        "dl4j_kernel_")

    def _collectives_panel(self) -> str:
        """Collective-exchange metrics (comms.scheduler +
        parallel.compression): per-op bytes/launch counters, bucket
        layouts, and the scheduler's per-plan choice counter
        (``dl4j_collective_plan_total{intent,choice}``) with the newest
        plan's bytes/launches gauges — which collective the scheduler
        picked, observable per fit."""
        return self._metric_table_panel("Collectives (scheduler)",
                                        "dl4j_collective_")

    def render_html(self, refresh_seconds: int = 0) -> str:
        """The dashboard as an HTML string."""
        records = [r for st in self._storages for r in st.records()]
        records.sort(key=lambda r: (r.get("session", ""),
                                    r.get("iteration", 0)))
        score = {}
        ratio = {}
        pmag = {}
        timing = {}
        hostmem = {}
        devmem = {}
        aotc = {}
        for r in records:
            it = r.get("iteration", 0)
            sess = r.get("session", "s")
            score.setdefault(sess, ([], []))
            score[sess][0].append(it)
            score[sess][1].append(r.get("score", float("nan")))
            if "iter_seconds" in r:
                timing.setdefault(sess, ([], []))
                timing[sess][0].append(it)
                timing[sess][1].append(r["iter_seconds"])
            for layer, v in r.get("update_param_ratio_log10", {}).items():
                ratio.setdefault(f"layer {layer}", ([], []))
                ratio[f"layer {layer}"][0].append(it)
                ratio[f"layer {layer}"][1].append(v)
            for layer, v in r.get("param_mean_mag", {}).items():
                pmag.setdefault(f"layer {layer}", ([], []))
                pmag[f"layer {layer}"][0].append(it)
                pmag[f"layer {layer}"][1].append(v)
            # system/hardware series (reference dashboard System tab:
            # host + per-device memory)
            sysm = r.get("system", {})
            if "host_rss_mb" in sysm:
                hostmem.setdefault("host RSS", ([], []))
                hostmem["host RSS"][0].append(it)
                hostmem["host RSS"][1].append(sysm["host_rss_mb"])
            for dev, dstats in sysm.get("devices", {}).items():
                for key, label in (("mem_in_use_mb", "in use"),
                                   ("peak_mem_mb", "peak")):
                    if key in dstats:
                        devmem.setdefault(f"{dev} {label}", ([], []))
                        devmem[f"{dev} {label}"][0].append(it)
                        devmem[f"{dev} {label}"][1].append(dstats[key])
            # the envelope cache (optimize.aot_cache): a rising miss
            # count after warmup = first forwards at new envelopes
            for key, label in (("misses", "compiles"), ("hits", "hits"),
                               ("compile_seconds", "compile s (cum)")):
                if key in sysm.get("aot_cache", {}):
                    aotc.setdefault(label, ([], []))
                    aotc[label][0].append(it)
                    aotc[label][1].append(sysm["aot_cache"][key])
        # latest histogram snapshot (reference dashboard histogram panels)
        latest_hists = {}
        for r in records:
            for key in ("param_histograms", "update_histograms",
                        "activation_histograms", "gradient_histograms"):
                if r.get(key):
                    latest_hists[key] = r[key]
        body = "".join([
            _chart("Model score vs iteration", score),
            _chart("log10 update:param ratio", ratio,
                   "(healthy ≈ -3)"),
            _chart("Parameter mean magnitude", pmag),
            _chart("Iteration time", timing, "seconds"),
            _chart("Host memory (RSS)", hostmem, "MB"),
            _chart("Device memory", devmem, "MB"),
            _chart("Envelope cache", aotc,
                   "(hits/misses cumulative; misses after warmup = "
                   "first forwards at new envelopes)"),
            _hist_panel("Parameter histograms (latest)",
                        latest_hists.get("param_histograms", {}),
                        "#1f77b4"),
            _hist_panel("Update histograms (latest)",
                        latest_hists.get("update_histograms", {}),
                        "#d62728"),
            _hist_panel("Activation histograms (latest)",
                        latest_hists.get("activation_histograms", {}),
                        "#2ca02c"),
            _hist_panel("Gradient histograms (latest)",
                        latest_hists.get("gradient_histograms", {}),
                        "#9467bd"),
            self._serving_panel(),
            self._generation_panel(),
            self._platform_panel(),
            self._slo_panel(),
            self._collectives_panel(),
            self._kernels_panel(),
            self._sharding_panel(),
            self._pod_panel(),
        ]) or "<p>No stats collected yet.</p>"
        refresh = (f"<meta http-equiv='refresh' content='{refresh_seconds}'>"
                   if refresh_seconds else "")
        return _page("deeplearning4j_tpu training",
                     f"<h1>Training dashboard</h1>{body}",
                     head_extra=refresh)
