"""The cards' power draw, sampled by ``nvidia-smi`` beside the window.

One ``nvidia-smi`` process reads each card that the run uses, selected by
its UUID, every ``interval_ms``; a thread stamps each line with the host's
clock. :meth:`PowerSampler.energy_j` integrates one card's samples over
the window, and :class:`Cards` sums the cards. Nothing stands in for a
reading: with too few samples of any card it raises.
"""

from __future__ import annotations

import shutil
import subprocess
import threading
import time

#: the card's power as ``nvidia-smi`` reads it at the moment of the query
FIELD = "power.draw.instant"


def card_uuid(torch, index: int = 0) -> str:
    """The card's UUID as ``nvidia-smi --id`` takes it (``GPU-...``)."""
    u = str(torch.cuda.get_device_properties(index).uuid)
    return u if u.startswith("GPU-") else "GPU-" + u


def probe(card: str) -> dict:
    """The name and power limit of the card ``nvidia-smi --id=card``
    selects; raises where it reads no power of it."""
    r = subprocess.run([_nvidia_smi(), f"--id={card}",
                        f"--query-gpu=name,power.limit,{FIELD}",
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=30)
    row = [x.strip() for x in r.stdout.strip().split(",")]
    try:
        limit, _ = float(row[1]), float(row[2])
    except (ValueError, IndexError):
        raise RuntimeError(f"nvidia-smi reads no power of {card}: "
                           f"{(r.stdout + r.stderr).strip()}") from None
    return {"card": card, "name": row[0], "power_limit_w": limit}


def _nvidia_smi() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found: the card's power cannot "
                           "be read")
    return smi


class PowerSampler:
    """Samples the power of the one card ``nvidia-smi --id=card``
    selects."""

    def __init__(self, card: str, interval_ms: int = 50):
        self.interval_ms = int(interval_ms)
        self.samples: list = []
        self._proc = None
        self._thread = None
        self._cmd = [_nvidia_smi(), f"--id={card}", f"--query-gpu={FIELD}",
                     "--format=csv,noheader,nounits",
                     f"--loop-ms={self.interval_ms}"]

    def start(self) -> None:
        self._proc = subprocess.Popen(self._cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.DEVNULL, text=True)
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self) -> None:
        for line in self._proc.stdout:
            now = time.perf_counter()
            try:
                self.samples.append((now, float(line)))
            except ValueError:
                continue

    def wait_for_samples(self, timeout_s: float = 15.0) -> None:
        """Return once a sample has come, or raise after ``timeout_s``."""
        end = time.perf_counter() + timeout_s
        while not self.samples:
            if time.perf_counter() > end or self._proc.poll() is not None:
                raise RuntimeError("nvidia-smi gave no power sample")
            time.sleep(0.01)

    def stop(self) -> None:
        if self._proc is None:
            return
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._thread.join(timeout=10)
        self._proc.stdout.close()
        self._proc = None

    def energy_j(self, t0: float, t1: float) -> float:
        """Joules over ``[t0, t1]`` (host clock): the samples' trapezoids,
        the first and last held flat to the window's edges."""
        pts = [(t, w) for t, w in self.samples if t0 <= t <= t1]
        need = max(3, int((t1 - t0) * 1e3 / self.interval_ms) // 4)
        if len(pts) < need:
            raise RuntimeError(f"{len(pts)} power samples in a window of "
                               f"{t1 - t0:.3f} s (need {need})")
        e = pts[0][1] * (pts[0][0] - t0) + pts[-1][1] * (t1 - pts[-1][0])
        for (ta, wa), (tb, wb) in zip(pts, pts[1:]):
            e += 0.5 * (wa + wb) * (tb - ta)
        return e


class Cards:
    """One :class:`PowerSampler` a card of the run; the window's energy is
    the sum of the cards' energies."""

    def __init__(self, cards, interval_ms: int = 50):
        self.each = [PowerSampler(c, interval_ms) for c in cards]

    def start(self) -> None:
        for s in self.each:
            s.start()

    def wait_for_samples(self, timeout_s: float = 15.0) -> None:
        for s in self.each:
            s.wait_for_samples(timeout_s)

    def stop(self) -> None:
        for s in self.each:
            s.stop()

    def energy_j(self, t0: float, t1: float) -> float:
        return sum(s.energy_j(t0, t1) for s in self.each)
