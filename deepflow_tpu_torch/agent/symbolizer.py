"""Stack symbolization + continuous-profiler aggregation — the eBPF

Port copy of deepflow_tpu/agent/symbolizer.py.
userspace half (reference: agent/src/ebpf/user/symbol.c ELF/symbol
resolution, profile/perf_profiler.c stack folding/aggregation,
profile/java jvm perf-map symbolization).

The kernel plane (perf events, uprobe attach) is environment-blocked in
this container; what the reference's USERSPACE does with the raw
samples is fully implemented here:

  * `ProcMaps` — /proc/<pid>/maps executable-range index (module base
    addresses for PIE/shared objects);
  * `ElfSymbols` — a dependency-free ELF64 .symtab/.dynsym reader
    (FUNC symbols, address-sorted) — symbol.c's bcc-backed table;
  * `JavaPerfMap` — /tmp/perf-<pid>.map (the JVM perf-map-agent /
    async-profiler convention symbol.c consumes for Java frames);
  * `Symbolizer` — address → "module!func" resolution with per-module
    caching and unknown-frame fallbacks ("[module+0xoff]");
  * `ProfileAggregator` — (pid, stack-addresses, weight) samples →
    folded "a;b;c weight" lines per interval, the wire shape the
    PROFILE ingest lane already accepts (integration/collector.py).
"""

from __future__ import annotations

import bisect
import dataclasses
import os
import struct


# ---------------------------------------------------------------------------
# /proc/<pid>/maps


@dataclasses.dataclass(frozen=True)
class MapRange:
    start: int
    end: int
    offset: int
    path: str


class ProcMaps:
    """Executable ranges of one process, sorted by start address."""

    def __init__(self, ranges: list[MapRange]):
        self.ranges = sorted(ranges, key=lambda r: r.start)
        self._starts = [r.start for r in self.ranges]

    @classmethod
    def read(cls, pid: int | str = "self") -> "ProcMaps":
        out = []
        try:
            with open(f"/proc/{pid}/maps") as f:
                for line in f:
                    parts = line.split(maxsplit=5)
                    if len(parts) < 5 or "x" not in parts[1]:
                        continue
                    lo, _, hi = parts[0].partition("-")
                    out.append(MapRange(
                        int(lo, 16), int(hi, 16), int(parts[2], 16),
                        parts[5].strip() if len(parts) == 6 else "",
                    ))
        except OSError:
            pass
        return cls(out)

    def find(self, addr: int) -> MapRange | None:
        i = bisect.bisect_right(self._starts, addr) - 1
        if i >= 0 and self.ranges[i].start <= addr < self.ranges[i].end:
            return self.ranges[i]
        return None


# ---------------------------------------------------------------------------
# ELF64 symbol tables (no pyelftools in-image — a ~60-line subset reads
# what symbol.c reads: FUNC symbols from .symtab and .dynsym)


def _read_elf_symbols(path: str) -> list[tuple[int, int, str]]:
    """[(addr, size, name)] for STT_FUNC symbols, both tables."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"\x7fELF" or data[4] != 2:  # ELF64 only
        return []
    little = data[5] == 1
    e = "<" if little else ">"
    shoff, = struct.unpack_from(e + "Q", data, 0x28)
    shentsize, shnum = struct.unpack_from(e + "HH", data, 0x3A)
    sections = []
    for i in range(shnum):
        off = shoff + i * shentsize
        if off + 64 > len(data):
            return []
        s_type, = struct.unpack_from(e + "I", data, off + 4)
        s_offset, s_size = struct.unpack_from(e + "QQ", data, off + 24)
        s_link, = struct.unpack_from(e + "I", data, off + 40)
        s_entsize, = struct.unpack_from(e + "Q", data, off + 56)
        sections.append((s_type, s_offset, s_size, s_link, s_entsize))
    out = []
    for s_type, s_offset, s_size, s_link, s_entsize in sections:
        if s_type not in (2, 11) or not s_entsize:  # SYMTAB, DYNSYM
            continue
        if s_link >= len(sections):
            continue
        _, str_off, str_size, _, _ = sections[s_link]
        strtab = data[str_off:str_off + str_size]
        for off in range(s_offset, s_offset + s_size, s_entsize):
            if off + 24 > len(data):
                break
            name_off, info = struct.unpack_from(e + "IB", data, off)
            value, size = struct.unpack_from(e + "QQ", data, off + 8)
            if info & 0xF != 2 or value == 0:  # STT_FUNC, defined
                continue
            end = strtab.find(b"\0", name_off)
            name = strtab[name_off:end].decode(errors="replace")
            if name:
                out.append((value, size, name))
    return out


class ElfSymbols:
    """Address-sorted FUNC symbols of one module."""

    def __init__(self, syms: list[tuple[int, int, str]]):
        self.syms = sorted(set(syms))
        self._addrs = [s[0] for s in self.syms]

    @classmethod
    def load(cls, path: str) -> "ElfSymbols":
        try:
            return cls(_read_elf_symbols(path))
        except (OSError, struct.error, IndexError, ValueError):
            # truncated/corrupt module files must not kill the
            # profiling loop — resolve falls back to module+offset
            return cls([])

    def resolve(self, vaddr: int) -> str | None:
        i = bisect.bisect_right(self._addrs, vaddr) - 1
        if i < 0:
            return None
        addr, size, name = self.syms[i]
        if size and vaddr >= addr + size:
            return None  # in a gap past the previous symbol
        return name


# ---------------------------------------------------------------------------
# JVM perf-map (symbol.c's java path: /tmp/perf-<pid>.map, lines of
# "HEXADDR HEXSIZE name")


class JavaPerfMap:
    def __init__(self, entries: list[tuple[int, int, str]]):
        self.entries = sorted(entries)
        self._addrs = [a for a, _, _ in self.entries]

    @classmethod
    def read(cls, pid: int, root: str = "/tmp") -> "JavaPerfMap":
        out = []
        try:
            with open(os.path.join(root, f"perf-{pid}.map")) as f:
                for line in f:
                    parts = line.split(maxsplit=2)
                    if len(parts) == 3:
                        try:
                            out.append(
                                (int(parts[0], 16), int(parts[1], 16),
                                 parts[2].strip())
                            )
                        except ValueError:
                            continue
        except OSError:
            pass
        return cls(out)

    def resolve(self, addr: int) -> str | None:
        i = bisect.bisect_right(self._addrs, addr) - 1
        if i < 0:
            return None
        start, size, name = self.entries[i]
        return name if addr < start + size else None


# ---------------------------------------------------------------------------
# symbolizer + profile aggregation


class Symbolizer:
    """Raw virtual addresses of one process → display frames."""

    def __init__(self, pid: int | str = "self", *, perf_map_root: str = "/tmp"):
        self.pid = pid
        self.maps = ProcMaps.read(pid)
        self._elfs: dict[str, ElfSymbols] = {}
        self.java = (
            JavaPerfMap.read(int(pid), perf_map_root)
            if str(pid).isdigit() else JavaPerfMap([])
        )
        self.counters = {"resolved": 0, "fallback": 0, "unknown": 0}

    def _module(self, path: str) -> ElfSymbols:
        m = self._elfs.get(path)
        if m is None:
            m = ElfSymbols.load(path) if path.startswith("/") else ElfSymbols([])
            self._elfs[path] = m
        return m

    def resolve(self, addr: int) -> str:
        jname = self.java.resolve(addr)
        if jname is not None:
            self.counters["resolved"] += 1
            return jname
        r = self.maps.find(addr)
        if r is None:
            self.counters["unknown"] += 1
            return f"[0x{addr:x}]"
        modname = os.path.basename(r.path) or "[anon]"
        # ET_DYN modules map at a base; symbol vaddrs are file-relative
        for vaddr in (addr - r.start + r.offset, addr):
            name = self._module(r.path).resolve(vaddr)
            if name is not None:
                self.counters["resolved"] += 1
                return f"{modname}!{name}"
        self.counters["fallback"] += 1
        return f"[{modname}+0x{addr - r.start:x}]"

    def fold(self, stack: list[int]) -> str:
        """Leaf-FIRST address list (the perf unwind order
        PerfStackSample documents) → root-first folded frame string.
        ';' inside a frame name (JVM signatures like 'Lcom/x/C;::m')
        would corrupt the folded framing — it maps to ':'."""
        return ";".join(
            self.resolve(a).replace(";", ":") for a in reversed(stack)
        )


class ProfileAggregator:
    """perf_profiler.c's fold/aggregate loop: raw samples in, folded
    per-interval lines out (the PROFILE wire shape)."""

    def __init__(self, *, app_service: str = "", event_type: str = "cpu"):
        self.app_service = app_service
        self.event_type = event_type
        self._symbolizers: dict[int | str, tuple[Symbolizer, float]] = {}
        self._counts: dict[str, int] = {}
        self.counters = {"samples": 0, "flushes": 0}

    # symbolizers refresh on an interval: pid reuse, late dlopen, and
    # growing JVM perf-maps all invalidate a snapshot (perf_profiler.c
    # re-reads its process caches the same way); the dict stays bounded
    # because expired entries are replaced in place and dead pids are
    # dropped at flush
    symbolizer_ttl_s: float = 60.0

    def symbolizer(self, pid: int | str) -> Symbolizer:
        import time as _time

        now = _time.monotonic()
        ent = self._symbolizers.get(pid)
        if ent is None or now - ent[1] > self.symbolizer_ttl_s:
            ent = (Symbolizer(pid), now)
            self._symbolizers[pid] = ent
        return ent[0]

    def observe(self, pid: int | str, stack: list[int], weight: int = 1) -> None:
        folded = self.symbolizer(pid).fold(stack)
        self._counts[folded] = self._counts.get(folded, 0) + int(weight)
        self.counters["samples"] += 1

    def observe_folded(self, folded: str, weight: int = 1) -> None:
        """Pre-symbolized stacks (the older intake) share the window."""
        self._counts[folded] = self._counts.get(folded, 0) + int(weight)
        self.counters["samples"] += 1

    def flush(self, timestamp: int) -> bytes | None:
        """→ one PROFILE frame body ("svc\\0type\\0ts\\n" + folded lines),
        the shape integration/collector.py ships and the profile
        ingester decodes; None when the window is empty."""
        # prune symbolizers of exited processes (bounds the cache)
        for pid in [p for p in self._symbolizers
                    if str(p).isdigit() and not os.path.exists(f"/proc/{p}")]:
            del self._symbolizers[pid]
        if not self._counts:
            return None
        lines = "\n".join(
            f"{stack} {n}" for stack, n in sorted(self._counts.items())
        )
        head = f"{self.app_service}\x00{self.event_type}\x00{timestamp}\n"
        self._counts.clear()
        self.counters["flushes"] += 1
        return (head + lines).encode()
