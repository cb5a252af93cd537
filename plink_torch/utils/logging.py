"""Run logging: console + <out>.log mirroring (ref: 2.0/plink2_cmdline.h:75-167).

Every invocation writes `<out prefix>.log` containing the banner, the command
line, and all console output — the reference's reproducibility contract.
"""

from __future__ import annotations

import sys
import time

from .. import __version__

_BANNER = f"PLINK-TORCH v{__version__} (plink_torch engine)"


class RunLogger:
    def __init__(self, out_prefix: str | None = None, silent: bool = False):
        self.silent = silent
        self._file = None
        self._start = time.time()
        if out_prefix:
            self._file = open(out_prefix + ".log", "w")

    def log(self, msg: str = "", console: bool = True) -> None:
        if console and not self.silent:
            sys.stdout.write(msg + "\n")
            sys.stdout.flush()
        if self._file:
            self._file.write(msg + "\n")

    def banner(self, argv: list[str] | None = None) -> None:
        self.log(_BANNER)
        if argv:
            self.log("Options in effect:")
            self.log("  " + " ".join(argv))
            self.log("")

    def elapsed(self) -> float:
        return time.time() - self._start

    def phase(self, name: str):
        """Context manager logging a per-phase wall time to the .log file
        (log-file-only: the reference's console stays clean, but SURVEY §5
        calls for per-phase timings as the tracing-parity artifact).

        Usage: `with log.phase("--freq"): ...`"""
        return _PhaseTimer(self, name)

    def close(self) -> None:
        if self._file:
            self.log(f"End time: {time.strftime('%a %b %d %H:%M:%S %Y')}",
                     console=False)
            self._file.close()
            self._file = None


class _PhaseTimer:
    def __init__(self, logger: "RunLogger", name: str):
        self._logger = logger
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self._t0
        tag = " (failed)" if exc_type is not None else ""
        self._logger.log(f"[phase] {self._name}: {dt:.3f}s{tag}",
                         console=False)
        return False


_global_logger: RunLogger | None = None


def get_logger() -> RunLogger:
    global _global_logger
    if _global_logger is None:
        _global_logger = RunLogger()
    return _global_logger


def set_logger(lg: RunLogger) -> None:
    global _global_logger
    _global_logger = lg
