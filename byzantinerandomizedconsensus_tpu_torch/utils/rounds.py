"""Round bookkeeping for the round-over-round regression guards.

The driver names per-round artifacts ``BENCH_r{N}.json`` (and this repo names
``artifacts/product_r{N}.json`` / ``acceptance_r{N}.json`` the same way).
"Previous round" is anchored on VERDICT.md's heading — the newest artifact on
disk may be the *current* round's (the driver writes it right before a judge
rerun), and comparing against it would always read ~1.0 and mask regressions
(VERDICT r2 #4). ADVICE r3: when VERDICT.md exists but its heading cannot be
parsed, warn and omit the comparison instead of silently falling back to the
newest artifact.
"""

from __future__ import annotations

import json
import pathlib
import re
import sys
from typing import Optional


def repo_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[2]


def verdict_round(root=None) -> tuple[bool, Optional[int]]:
    """(verdict_exists, judged_round); judged_round is None when the heading
    cannot be parsed."""
    p = pathlib.Path(root or repo_root()) / "VERDICT.md"
    try:
        text = p.read_text()
    except OSError:
        return False, None
    m = re.search(r"VERDICT\s*[—-]+\s*round\s+(\d+)", text)
    return True, (int(m.group(1)) if m else None)


def this_round(root=None) -> Optional[int]:
    """The build round in progress: VERDICT's judged round + 1 (round 1 when no
    VERDICT exists yet); None when VERDICT exists but is unparseable."""
    exists, judged = verdict_round(root)
    if not exists:
        return 1
    return None if judged is None else judged + 1


def default_artifact(stem: str, root=None, subdir: str = "artifacts") -> str:
    """Round-stamped default artifact path: ``{subdir}/{stem}_r{N}.json``,
    falling back to an unstamped name when the round is unknown (unparseable
    VERDICT heading). Single source for every tool's ``--out`` default so the
    naming scheme and :func:`prev_round_artifact`'s lookup cannot drift apart."""
    rnd = this_round(root)
    return (f"{subdir}/{stem}_r{rnd}.json" if rnd
            else f"{subdir}/{stem}.json")


def prev_round_artifact(stem: str, root=None, subdir: str = "", usable=None):
    """(name, round, parsed_json) of the newest ``{stem}_r*.json`` eligible as
    "previous round" (round ≤ VERDICT's judged round), or None.

    ``usable(doc) -> bool`` filters artifacts that parsed but carry no usable
    payload (e.g. a failed driver capture with no value): the search falls back
    to the next-older round instead of returning a dead artifact and silently
    disabling the regression guard.

    When VERDICT.md exists but its round heading cannot be parsed, emits a
    stderr warning and returns None — never the newest artifact, which right
    after a driver capture is the current run itself (ADVICE r3).
    """
    root = pathlib.Path(root or repo_root())
    exists, cap = verdict_round(root)
    if exists and cap is None:
        print(f"warning: VERDICT.md present but its round heading is "
              f"unparseable; omitting the {stem} vs_prev_round comparison "
              f"(falling back to the newest artifact risks self-comparison)",
              file=sys.stderr)
        return None
    candidates = []
    for p in (root / subdir if subdir else root).glob(f"{stem}_r*.json"):
        m = re.match(rf"{re.escape(stem)}_r0*(\d+)\.json", p.name)
        if not m:
            continue
        rnd = int(m.group(1))
        if cap is None or rnd <= cap:
            candidates.append((rnd, p))
    for rnd, p in sorted(candidates, reverse=True):
        try:
            doc = json.loads(p.read_text())
        except (OSError, ValueError):
            continue
        if usable is not None and not usable(doc):
            continue
        return (p.name, rnd, doc)
    return None
