"""Logging / progress / memory observability (SURVEY.md §5 metrics tier).

The reference's only real logging subsystem is Flye's, vendored in
kmer-cnt: a singleton logger with error/warning/info/debug levels,
`[YYYY-MM-DD HH:MM:SS] LEVEL: msg` timestamps and an optional file sink
(benchmarks/kmer-cnt/logger.h), a console progress bar
(benchmarks/kmer-cnt/progress_bar.h, enabled via
VertexIndex::outputProgress, vertex_index.cpp:236), and peak-RSS
reporting (benchmarks/kmer-cnt/memory_info.h getPeakRSS, printed at
kmer_cnt.cpp:282-283 and msa_spoa_omp.cpp:499).  This module provides
the same capabilities for every driver here.
"""

from __future__ import annotations

import sys
import time


class Logger:
    """Singleton logger with Flye's line format (logger.h Logger::get())."""

    _instance = None

    def __init__(self):
        self.debugging = False
        self._file = None

    @classmethod
    def get(cls) -> "Logger":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def set_debugging(self, flag: bool):
        self.debugging = bool(flag)

    def set_output_file(self, path: str):
        if self._file is not None:
            self._file.close()
        self._file = open(path, "a")

    def _emit(self, level: str, msg: str, to_console: bool):
        stamp = time.strftime("[%Y-%m-%d %H:%M:%S]")
        line = f"{stamp} {level}: {msg}"
        if to_console:
            print(line, file=sys.stderr)
        if self._file is not None:
            self._file.write(line + "\n")
            self._file.flush()

    def error(self, msg):
        self._emit("ERROR", str(msg), True)

    def warning(self, msg):
        self._emit("WARNING", str(msg), True)

    def info(self, msg):
        self._emit("INFO", str(msg), True)

    def debug(self, msg):
        # debug lines always reach the file sink; console only with -d
        self._emit("DEBUG", str(msg), self.debugging)


class ProgressPercent:
    """Console percent progress (progress_bar.h ProgressPercent)."""

    def __init__(self, final_count: int, stream=sys.stderr, width: int = 41):
        self.final = max(int(final_count), 1)
        self.count = 0
        self._last_shown = -1
        self._stream = stream
        self._width = width

    def advance(self, delta: int = 1):
        self.count += delta
        pct = self.count * 100 // self.final
        if pct != self._last_shown:
            self._last_shown = pct
            filled = pct * (self._width - 1) // 100
            bar = "#" * filled + "-" * (self._width - 1 - filled)
            self._stream.write(f"\r[{bar}] {pct}% ")
            self._stream.flush()
            if pct >= 100:
                self._stream.write("\n")


def get_peak_rss() -> int:
    """Peak resident set size in bytes (memory_info.h getPeakRSS)."""
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # Linux reports KiB; macOS reports bytes
        return ru * 1024 if sys.platform != "darwin" else ru
    except Exception:
        return 0


def get_memory_size() -> int:
    """Total system RAM in bytes (memory_info.h getMemorySize)."""
    try:
        import os

        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        return 0
