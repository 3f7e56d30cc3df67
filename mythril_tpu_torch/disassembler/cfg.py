"""Static control-flow graph over disassembled bytecode.

Reference: ``mythril/laser/ethereum/cfg.py`` (⚠unv, SURVEY.md §2 row
"CFG") builds Node/Edge/JumpType DURING symbolic execution. Frontier-
first that bookkeeping would serialize the hot loop, so the graph here is
built STATICALLY from the instruction stream (basic blocks, fall-through,
push-immediate jump targets — which covers solc's dispatcher and loop
shapes), and the exploration's visited-pc bitmap (``sym_run
track_coverage``) can be overlaid afterwards to mark reached blocks.
Feeds ``--graph`` DOT output; the bounded-loops policy intentionally does
NOT depend on it (it counts dynamic back-jumps per lane instead).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

import numpy as np

from .disassembly import EvmInstruction, disassemble

BLOCK_ENDERS = {"JUMP", "JUMPI", "STOP", "RETURN", "REVERT", "SELFDESTRUCT",
                "INVALID"}


class JumpType(Enum):
    CONDITIONAL = "conditional"
    UNCONDITIONAL = "unconditional"
    FALLTHROUGH = "fallthrough"


@dataclass
class Node:
    uid: int
    start: int                    # pc of first instruction
    end: int                      # pc of last instruction
    instructions: List[EvmInstruction] = field(default_factory=list)
    reached: Optional[bool] = None  # filled from a visited bitmap

    def lines(self, limit: int = 20):
        """Formatted instruction lines (one truncation rule for every
        rendering — DOT and HTML must not drift)."""
        out = [f"{i.address} {i.name}"
               + (f" 0x{i.argument.hex()}" if i.argument else "")
               for i in self.instructions[:limit]]
        if len(self.instructions) > limit:
            out.append("...")
        return out

    @property
    def label(self) -> str:
        head = f"{self.start}..{self.end}"
        return head + "\\l" + "\\l".join(self.lines()) + "\\l"


@dataclass
class Edge:
    src: int    # node uid
    dst: int
    jump_type: JumpType


class CFG:
    """Basic blocks + static edges for one contract's bytecode."""

    def __init__(self, code: bytes):
        self.instructions = disassemble(code)
        self.nodes: List[Node] = []
        self.edges: List[Edge] = []
        self._build()

    def _build(self) -> None:
        instrs = self.instructions
        if not instrs:
            return
        # leaders: entry, jumpdests, instruction after a block ender
        leaders = {instrs[0].address}
        for i, ins in enumerate(instrs):
            if ins.name == "JUMPDEST":
                leaders.add(ins.address)
            if ins.name in BLOCK_ENDERS and i + 1 < len(instrs):
                leaders.add(instrs[i + 1].address)
        node_of_pc: Dict[int, int] = {}
        cur: Optional[Node] = None
        for ins in instrs:
            if ins.address in leaders or cur is None:
                cur = Node(uid=len(self.nodes), start=ins.address,
                           end=ins.address)
                self.nodes.append(cur)
            cur.instructions.append(ins)
            cur.end = ins.address
            node_of_pc[ins.address] = cur.uid
        self._node_of_pc = node_of_pc

        # edges
        for n in self.nodes:
            last = n.instructions[-1]
            nxt = last.address + 1 + len(last.argument or b"")
            if last.name == "JUMPI" and nxt in node_of_pc:
                self.edges.append(Edge(n.uid, node_of_pc[nxt],
                                       JumpType.FALLTHROUGH))
            elif last.name not in BLOCK_ENDERS and nxt in node_of_pc:
                self.edges.append(Edge(n.uid, node_of_pc[nxt],
                                       JumpType.FALLTHROUGH))
            if last.name in ("JUMP", "JUMPI"):
                tgt = self._static_target(n)
                if tgt is not None and tgt in node_of_pc:
                    jt = (JumpType.CONDITIONAL if last.name == "JUMPI"
                          else JumpType.UNCONDITIONAL)
                    self.edges.append(Edge(n.uid, node_of_pc[tgt], jt))

    @staticmethod
    def _static_target(n: Node) -> Optional[int]:
        """PUSH immediately feeding the jump (solc's canonical shape)."""
        if len(n.instructions) >= 2:
            prev = n.instructions[-2]
            if prev.name.startswith("PUSH") and prev.argument:
                return int.from_bytes(prev.argument, "big")
        return None

    def node_at(self, pc: int) -> Optional[Node]:
        uid = self._node_of_pc.get(pc)
        return self.nodes[uid] if uid is not None else None

    def mark_reached(self, visited: np.ndarray) -> None:
        """Overlay a visited-pc bitmap (bool[max_code]) from sym_run."""
        for n in self.nodes:
            n.reached = bool(visited[n.start]) if n.start < len(visited) else False

    def as_dot(self, name: str = "cfg") -> str:
        out = [f'digraph "{name}" {{', '  node [shape=box fontname="monospace"];']
        for n in self.nodes:
            style = ""
            if n.reached is True:
                style = ' style=filled fillcolor="#c8e6c9"'
            elif n.reached is False:
                style = ' style=filled fillcolor="#eeeeee"'
            out.append(f'  n{n.uid} [label="{n.label}"{style}];')
        styles = {JumpType.CONDITIONAL: "dashed",
                  JumpType.UNCONDITIONAL: "solid",
                  JumpType.FALLTHROUGH: "dotted"}
        for e in self.edges:
            out.append(f'  n{e.src} -> n{e.dst} [style={styles[e.jump_type]}];')
        out.append("}")
        return "\n".join(out)

    def as_html(self, name: str = "cfg") -> str:
        """Self-contained interactive HTML view (reference:
        ``--graph out.html`` renders the LASER graph with a bundled JS
        layout, ``mythril/analysis/callgraph.py`` ⚠unv). Zero external
        resources — the layout is a small inline script (layered by
        basic-block order, SVG edges, hover highlights, reached blocks
        tinted), so the file opens anywhere including air-gapped boxes.
        """
        import html as _html
        import json as _json

        nodes = [{
            "uid": n.uid, "start": n.start, "end": n.end,
            "reached": n.reached,
            "text": "\n".join(n.lines()),
        } for n in self.nodes]
        edges = [{"src": e.src, "dst": e.dst, "kind": e.jump_type.name}
                 for e in self.edges]
        payload = _json.dumps({"name": name, "nodes": nodes,
                               "edges": edges})
        # placeholders a hostile contract NAME cannot smuggle into the
        # other substitution: the data slot includes quotes (json escapes
        # any quote in `name` to \"), the title slot includes <> (html
        # escaping turns them into entities)
        return (_HTML_TEMPLATE
                .replace('"@DATA@"', payload)
                .replace("<!--TITLE-->", _html.escape(name)))


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title><!--TITLE--> — CFG</title>
<style>
 body{font-family:monospace;background:#1e1e1e;color:#ddd;margin:0}
 #hdr{padding:8px 12px;background:#2d2d2d;position:sticky;top:0}
 svg{display:block}
 .blk rect{fill:#263238;stroke:#546e7a;rx:4}
 .blk.reached rect{fill:#1b3a2a;stroke:#66bb6a}
 .blk.unreached rect{fill:#2a2a2a;stroke:#555}
 .blk:hover rect{stroke:#ffca28;stroke-width:2}
 .blk text{fill:#ddd;font-size:11px;white-space:pre}
 path.CONDITIONAL{stroke:#ffb74d;stroke-dasharray:6 3}
 path.UNCONDITIONAL{stroke:#4fc3f7}
 path.FALLTHROUGH{stroke:#9e9e9e;stroke-dasharray:2 3}
 path{fill:none;stroke-width:1.5;opacity:.8}
</style></head><body>
<div id="hdr"><!--TITLE--> — control-flow graph (green = explored)</div>
<div id="g"></div>
<script>
const D = "@DATA@";
const CW = 8, LH = 13, PADX = 10, PADY = 8, GAPX = 40, GAPY = 46;
// flow layout: blocks in pc order, wrapping rows; curved SVG edges
let x = 20, y = 20, rowH = 0, maxW = 0;
const pos = {};
D.nodes.sort((a,b)=>a.start-b.start).forEach(n => {
  const lines = n.text.split("\\n");
  const w = PADX*2 + CW*Math.max(...lines.map(l=>l.length), 8);
  const h = PADY*2 + LH*lines.length;
  if (x + w > 1500) { x = 20; y += rowH + GAPY; rowH = 0; }
  pos[n.uid] = {x, y, w, h, n, lines};
  x += w + GAPX; rowH = Math.max(rowH, h); maxW = Math.max(maxW, x);
});
const H = y + rowH + 40;
let svg = `<svg width="${Math.max(maxW,800)}" height="${H}" xmlns="http://www.w3.org/2000/svg">`;
D.edges.forEach(e => {
  const a = pos[e.src], b = pos[e.dst]; if (!a || !b) return;
  const x1 = a.x + a.w/2, y1 = a.y + a.h, x2 = b.x + b.w/2, y2 = b.y;
  const my = (y1 + y2) / 2;
  svg += `<path class="${e.kind}" d="M${x1},${y1} C${x1},${my} ${x2},${my} ${x2},${y2}"/>`;
});
D.nodes.forEach(n => {
  const p = pos[n.uid];
  const cls = n.reached === true ? "blk reached" :
              n.reached === false ? "blk unreached" : "blk";
  svg += `<g class="${cls}"><rect x="${p.x}" y="${p.y}" width="${p.w}" height="${p.h}"/>`;
  p.lines.forEach((l, i) => {
    svg += `<text x="${p.x+PADX}" y="${p.y+PADY+LH*(i+0.8)}">${l
      .replace(/&/g,"&amp;").replace(/</g,"&lt;")}</text>`;
  });
  svg += `</g>`;
});
svg += `</svg>`;
document.getElementById("g").innerHTML = svg;
</script></body></html>
"""
