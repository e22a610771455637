"""Graph visualization: a DOT writer and a terminal layer table — a copy of
``planer_tpu/utils/plot.py`` (pure Python over the IR), so both packages
draw the same graph as the same DOT text.  ``Net.show`` calls it.
"""
from __future__ import annotations

from ..ir import Graph

__all__ = ["plot_net", "to_dot"]


def to_dot(graph: Graph) -> str:
    lm = graph.layer_map()
    # tensor-level edges: map tensor -> producing layer
    producer: dict[str, str] = {}
    lines2 = ["digraph net {", "  rankdir=TB;",
              "  node [shape=box, fontsize=10];"]
    for name in graph.inputs:
        lines2.append(f'  "in:{name}" [label="{name}", shape=ellipse, '
                      f'style=filled, fillcolor=lightblue];')
        producer[name] = f"in:{name}"
    for e in graph.flow:
        for li, lname in enumerate(e.layers):
            lines2.append(f'  "{lname}" [label="{lname}\\n[{lm[lname].op}]"];')
            srcs = e.src if li == 0 else e.dst
            for s in srcs:
                if s in producer:
                    lines2.append(f'  "{producer[s]}" -> "{lname}";')
            for d in e.dst:
                producer[d] = lname
    lines2.append("}")
    return "\n".join(lines2)


def plot_net(graph: Graph, path: str | None = None) -> str:
    print(f"inputs: {graph.inputs}")
    print(f"{'layer':<28}{'op':<22}params")
    print("-" * 70)
    lm = graph.layer_map()
    for e in graph.flow:
        for lname in e.layers:
            l = lm[lname]
            print(f"{lname:<28}{l.op:<22}{l.kwargs}")
    dot = to_dot(graph)
    if path:
        with open(path, "w") as f:
            f.write(dot)
        print(f"DOT written to {path}")
    return dot
