"""``nvidia-smi`` beside a run: each card's name and power limit, and samples of its
clocks, power draw and temperature while the window runs.  Where the tool is absent (a
machine without a card) every reading is empty."""

from __future__ import annotations

import shutil
import subprocess
import threading
import time

SAMPLED = "index,clocks.sm,clocks.mem,power.draw,temperature.gpu"


def cards() -> list:
    """``name, power limit`` of every card, one string each."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return []
    try:
        out = subprocess.run([exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


class Sampler:
    """``nvidia-smi`` sampling every card once a ``period_ms`` in a child process, each
    line stamped with the host's ``time.time()`` when read.  ``stop`` ends the child and
    returns [(time, "index, sm MHz, mem MHz, W, C"), ...]."""

    def __init__(self, period_ms: int = 1000):
        self.samples = []
        self._proc = None
        self._reader = None
        exe = shutil.which("nvidia-smi")
        if exe is None:
            return
        self._proc = subprocess.Popen(
            [exe, f"--query-gpu={SAMPLED}", "--format=csv,noheader,nounits",
             f"--loop-ms={period_ms}"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self._proc.stdout:
            self.samples.append((time.time(), line.strip()))

    def stop(self) -> list:
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()
            self._reader.join(timeout=10)
            self._proc.stdout.close()
            self._proc = None
        return self.samples


def within(samples, start: float, end: float) -> list:
    """The samples read between two ``time.time()`` stamps."""
    return [line for t, line in samples if start <= t <= end]
