"""Host ms a serving batch in padding and copying its waveforms, from the
program's spans: `serve.pad` (the ragged batch padded to its bucket) plus
`serve.copy` (pinned and copied to the card). The line gives every serving
span, host and device ms with their self time, and the count of every span
recorded, by name."""
from port_bench.metrics import _spans as S

NAMES = ("serve.pad", "serve.copy")


def read(ctx):
    spans, groups = S.read(ctx)
    if not groups:
        return None
    value = sum(S.host_ms(s) for g in groups.values() for s in g
                if s["name"] in NAMES) / len(groups)
    ctx["say"](f"[{ctx['metric']}] batches={len(groups)} "
               f"name=host_ms/self,device_ms/self(count) {S.table(groups)} "
               f"spans_recorded={S.counts(spans)}")
    return value
