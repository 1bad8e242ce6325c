"""Packed dynamic-tag strings (port of the `pack_tags` / `unpack_tags`
pair of deepflow_tpu/integration/formats.py; the rest of that module —
the Influx, Prometheus remote-write and OTLP codecs — is not ported).

The ClickHouse map-column stand-in: `k=v` pairs sorted by key, joined by
`,`; keys and values may contain `,` `=` `\\`, escaped on pack and
unescaped on parse. The deepflow_system sinks pack with it, and a label
selector reads the labels back with `unpack_tags`.
"""

from __future__ import annotations


def pack_tags(tags: dict[str, str]) -> str:
    def esc(s: str) -> str:
        return s.replace("\\", "\\\\").replace(",", "\\,").replace("=", "\\=")

    return ",".join(f"{esc(k)}={esc(v)}" for k, v in sorted(tags.items()))


def unpack_tags(packed: str) -> dict[str, str]:
    out: dict[str, str] = {}
    key, cur, esc_on = None, [], False
    for ch in packed:
        if esc_on:
            cur.append(ch)
            esc_on = False
        elif ch == "\\":
            esc_on = True
        elif ch == "=" and key is None:
            key = "".join(cur)
            cur = []
        elif ch == ",":
            if key is not None:
                out[key] = "".join(cur)
            key, cur = None, []
        else:
            cur.append(ch)
    if key is not None:
        out[key] = "".join(cur)
    return out
