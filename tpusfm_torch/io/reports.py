"""Match-graph reports: SVG adjacency matrices, graphviz export, graph
statistics (port of ``tpusfm/io/reports.py``, host-only).

Parity with the reference's matching diagnostics
(src/sparseBuilder/sparseBuilder.cpp:1010-1019 and 1249-1269:
PairWiseMatchingToAdjacencyMatrixSVG, exportToGraphvizData, and the
printed graph statistics after the putative and geometric stages)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_adjacency_svg(path, n_views: int, pair_list, counts, cell: int = 12):
    """SVG adjacency matrix: cell (i, j) shaded by match count."""
    counts = np.asarray(counts)
    mat = np.zeros((n_views, n_views))
    for (i, j), c in zip(np.asarray(pair_list), counts):
        mat[i, j] = mat[j, i] = c
    vmax = max(mat.max(), 1)
    size = n_views * cell
    rows = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" height="{size}">',
        f'<rect width="{size}" height="{size}" fill="white"/>',
    ]
    for i in range(n_views):
        for j in range(n_views):
            if mat[i, j] > 0:
                shade = int(255 * (1.0 - 0.9 * mat[i, j] / vmax))
                rows.append(
                    f'<rect x="{j*cell}" y="{i*cell}" width="{cell-1}" height="{cell-1}" '
                    f'fill="rgb(0,{shade},0)"><title>({i},{j}): {int(mat[i,j])}</title></rect>'
                )
    rows.append("</svg>")
    Path(path).write_text("\n".join(rows))


def write_graphviz(path, pair_list, counts):
    """DOT export of the view graph (exportToGraphvizData parity)."""
    lines = ["graph matches {"]
    for (i, j), c in zip(np.asarray(pair_list), np.asarray(counts)):
        if c > 0:
            lines.append(f'  v{i} -- v{j} [label="{int(c)}"];')
    lines.append("}")
    Path(path).write_text("\n".join(lines))


def write_html_report(path, report: dict, svg_files: list[str] | None = None):
    """Self-contained HTML reconstruction report (parity: the OpenMVG
    SfMReport HTML written at sparseBuilder.cpp:1583-1584)."""
    rows = "".join(
        f"<tr><th>{k}</th><td><pre style='margin:0'>{_fmt(v)}</pre></td></tr>"
        for k, v in report.items()
    )
    svgs = ""
    for f in svg_files or []:
        p = Path(f)
        if p.exists():
            svgs += f"<h3>{p.name}</h3>\n{p.read_text()}\n"
    html = (
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>tpusfm reconstruction report</title>"
        "<style>body{font-family:sans-serif;max-width:900px;margin:2em auto}"
        "table{border-collapse:collapse}th,td{border:1px solid #ccc;"
        "padding:4px 8px;text-align:left;vertical-align:top}</style></head><body>"
        f"<h1>tpusfm reconstruction report</h1><table>{rows}</table>{svgs}"
        "</body></html>"
    )
    Path(path).write_text(html)


def _fmt(v):
    import json

    if isinstance(v, (dict, list)):
        return json.dumps(v, indent=1)
    return str(v)


def graph_stats(n_views: int, pair_list, counts) -> dict:
    """Connected components + degree statistics of the view graph (the
    reference prints these after matching, .cpp:1010/1249)."""
    counts = np.asarray(counts)
    adj = [[] for _ in range(n_views)]
    n_edges = 0
    for (i, j), c in zip(np.asarray(pair_list), counts):
        if c > 0:
            adj[i].append(j)
            adj[j].append(i)
            n_edges += 1
    seen = np.zeros(n_views, bool)
    components = []
    for start in range(n_views):
        if seen[start]:
            continue
        stack = [start]
        seen[start] = True
        size = 0
        while stack:
            u = stack.pop()
            size += 1
            for v in adj[u]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(v)
        components.append(size)
    degrees = np.asarray([len(a) for a in adj])
    return {
        "n_views": n_views,
        "n_edges": int(n_edges),
        "n_components": len(components),
        "largest_component": int(max(components) if components else 0),
        "min_degree": int(degrees.min() if n_views else 0),
        "max_degree": int(degrees.max() if n_views else 0),
        "mean_degree": float(degrees.mean() if n_views else 0.0),
    }
