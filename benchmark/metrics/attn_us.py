"""ST-MEM's attention kernels' device time a record (us): the summed device
time of the kernels named in ``benchmark/kernels/*.json`` with ``"engine":
"attention"`` over the ``rows`` of the window's ``st_mem.encoder`` spans, one
span a chunk.  A window whose program records no ``st_mem.attention`` span
reads nothing.  ``attention_spans`` and ``attention_s`` serve
``attn_roofline`` too."""

from benchmark import run
from benchmark.metrics.step_idle_pct import program_spans


def attention_kernels() -> frozenset:
    names = set()
    for f in sorted((run.HERE / "kernels").glob("*.json")):
        d = run.load_json(f)
        if d.get("engine") == "attention":
            names.update(d["kernels"])
    return frozenset(names)


def attention_spans(ctx) -> list:
    return [s for s in program_spans(ctx) or () if s.name == "st_mem.attention"]


def attention_s(ctx) -> float:
    """Summed device seconds of the attention kernels in the window."""
    names = attention_kernels()
    return sum(s for k, (_, s) in ctx.trace.by_kernel.items() if k in names)


def read(ctx):
    if not attention_spans(ctx):
        return None
    rows = sum(s.counts["rows"] for s in program_spans(ctx) if s.name == "st_mem.encoder")
    a = attention_s(ctx)
    if not a or not rows:
        return None
    return 1e6 * a / rows
