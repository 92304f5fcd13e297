#!/usr/bin/env python
"""flame: merge per-rank sampling profiles into one flamegraph.

Input: one or more ``GET /profile`` payloads (``common/profiler.py``)
— either JSON files saved from the endpoint or ``http(s)://`` URLs
fetched live (signed with the job secret, the hvdtop contract).  Each
payload's collapsed stacks are prefixed with a ``rank N`` root frame
and count-merged, so one picture answers "where is the whole job's
wall time going, per rank".

Output:

  * a **collapsed-stack file** (``-o``): one ``stack count`` line per
    unique stack, the brendangregg format every external flamegraph
    tool eats;
  * a **self-contained SVG flamegraph** (``--svg``): no scripts, no
    external assets — width ∝ sample share, depth = stack depth,
    hover titles carry exact counts.  Minimal by design: the point is
    a one-file artifact a drill or CI run can attach.

CLI::

    python -m horovod_tpu_torch.tools.flame prof-r0.json prof-r1.json \\
        -o job.collapsed --svg job.svg

Prints a per-rank summary on stdout; exits 2 when an input is
unreadable, not a profile payload, or carries no samples (the
blackbox_merge/tune_report exit-code contract).

Counterpart of the JAX package's ``tools/flame.py``, signing with the
port's ``runner/job_secret.py`` (the same contract): the same collapsed
file and SVG for the same payloads.
"""

import argparse
import json
import os
import sys
import time
import urllib.error
import urllib.request
from typing import Dict, List, Tuple

from ..runner import job_secret



class FlameError(RuntimeError):
    pass


def _fetch(url: str, secret: str = "", timeout: float = 5.0) -> dict:
    if not url.rstrip("/").endswith("/profile"):
        url = url.rstrip("/") + "/profile"
    headers = {}
    if secret:
        path = "/" + url.split("://", 1)[-1].split("/", 1)[-1]
        ts = repr(time.time())
        headers = {
            job_secret.TS_HEADER: ts,
            job_secret.HEADER: job_secret.sign(secret, "GET", path,
                                               b"", ts),
        }
    req = urllib.request.Request(url, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def load_profiles(inputs: List[str], secret: str = "") -> List[dict]:
    """Load every input (file path or URL) as a /profile payload.
    Raises FlameError (→ exit 2) on unreadable/invalid/foreign input
    — a truncated profile must fail crisply, not render empty."""
    out = []
    for src in inputs:
        if src.startswith(("http://", "https://")):
            try:
                d = _fetch(src, secret)
            except (OSError, urllib.error.URLError, ValueError) as e:
                raise FlameError("%s: fetch failed: %s" % (src, e))
        else:
            try:
                with open(src) as fh:
                    d = json.load(fh)
            except (OSError, ValueError) as e:
                raise FlameError("%s: unreadable or invalid JSON: %s"
                                 % (src, e))
        if not isinstance(d, dict) or "collapsed" not in d:
            raise FlameError(
                "%s: not a /profile payload (no 'collapsed' stacks — "
                "was the profiler armed with HOROVOD_PROFILE=1?)"
                % src)
        if not isinstance(d["collapsed"], dict):
            raise FlameError("%s: malformed 'collapsed' section" % src)
        d.setdefault("_source", src)
        out.append(d)
    return out


def merge_collapsed(profiles: List[dict]) -> Dict[str, int]:
    """One ``stack -> count`` map with a ``rank N`` root frame per
    contributor (unranked payloads fold under ``rank ?``)."""
    merged: Dict[str, int] = {}
    for d in profiles:
        rank = d.get("rank")
        root = "rank %s" % (rank if rank is not None else "?")
        for stack, n in d["collapsed"].items():
            try:
                n = int(n)
            except (TypeError, ValueError):
                continue
            if n <= 0:
                continue
            key = "%s;%s" % (root, stack)
            merged[key] = merged.get(key, 0) + n
    return merged


def render_collapsed(merged: Dict[str, int]) -> str:
    return "".join("%s %d\n" % (stack, n)
                   for stack, n in sorted(merged.items()))


# ---------------------------------------------------------------------------
# minimal self-contained SVG flamegraph
# ---------------------------------------------------------------------------

_ROW_H = 16
_MIN_W = 0.5          # px: cells narrower than this are elided
_PALETTE = ("#e4683f", "#e78f3c", "#eab13b", "#d9c53e", "#b8c457",
            "#8fba6a", "#6aa87d")


def _build_tree(merged: Dict[str, int]):
    """Nested dict tree: frame -> (self+child count, children)."""
    root: Tuple[list, dict] = [0, {}]
    for stack, n in merged.items():
        node = root
        node[0] += n
        for frame in stack.split(";"):
            child = node[1].setdefault(frame, [0, {}])
            child[0] += n
            node = child
    return root


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def render_svg(merged: Dict[str, int], width: int = 1200,
               title: str = "horovod_tpu profile") -> str:
    root = _build_tree(merged)
    total = max(1, root[0])

    def depth_of(node, d=0):
        return max([d] + [depth_of(c, d + 1)
                          for c in node[1].values()])

    height = (depth_of(root) + 2) * _ROW_H + 24
    cells: List[str] = []

    def walk(node, x: float, depth: int):
        cx = x
        for frame, child in sorted(node[1].items()):
            w = width * child[0] / total
            if w >= _MIN_W:
                y = height - (depth + 1) * _ROW_H - 4
                color = _PALETTE[(hash(frame) & 0x7fffffff)
                                 % len(_PALETTE)]
                label = _esc(frame) if w > 40 else ""
                pct = 100.0 * child[0] / total
                cells.append(
                    '<g><title>%s — %d samples (%.1f%%)</title>'
                    '<rect x="%.1f" y="%d" width="%.1f" height="%d" '
                    'fill="%s" stroke="#fff" stroke-width="0.4"/>'
                    '<text x="%.1f" y="%d" font-size="10" '
                    'font-family="monospace" clip-path="none">%s'
                    '</text></g>'
                    % (_esc(frame), child[0], pct, cx, y, w,
                       _ROW_H - 1, color, cx + 2, y + _ROW_H - 5,
                       label[:max(1, int(w / 7))]))
                walk(child, cx, depth + 1)
            cx += w

    walk(root, 0.0, 0)
    return (
        '<svg xmlns="http://www.w3.org/2000/svg" width="%d" '
        'height="%d" viewBox="0 0 %d %d">\n'
        '<rect width="100%%" height="100%%" fill="#fdfdfd"/>\n'
        '<text x="4" y="14" font-size="12" font-family="monospace">'
        '%s — %d samples</text>\n%s\n</svg>\n'
        % (width, height, width, height, _esc(title), total,
           "\n".join(cells)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="flame", description="merge per-rank /profile payloads "
        "into one collapsed-stack file + SVG flamegraph "
        "(docs/observability.md)")
    p.add_argument("inputs", nargs="+",
                   help="profile JSON files or endpoint URLs")
    p.add_argument("-o", "--out", default=None,
                   help="write the merged collapsed-stack file here")
    p.add_argument("--svg", default=None,
                   help="write the SVG flamegraph here")
    p.add_argument("--secret", default=os.environ.get(
        "HOROVOD_SECRET_KEY", ""),
        help="job secret for signed URL fetches "
             "(default: HOROVOD_SECRET_KEY)")
    p.add_argument("--width", type=int, default=1200,
                   help="SVG width in px")
    args = p.parse_args(argv)
    try:
        profiles = load_profiles(args.inputs, args.secret)
        merged = merge_collapsed(profiles)
        if not merged:
            raise FlameError(
                "no samples in any input (profiler just armed, or "
                "hz too low for the capture window?)")
    except FlameError as e:
        print("flame: %s" % e, file=sys.stderr)
        return 2
    for d in profiles:
        print("rank %s: %s samples, %s stacks (%s)" % (
            d.get("rank", "?"), d.get("thread_samples", "?"),
            len(d.get("collapsed") or {}), d.get("_source")))
    print("merged: %d unique stacks, %d samples"
          % (len(merged), sum(merged.values())))
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(render_collapsed(merged))
        print("collapsed -> %s" % args.out)
    if args.svg:
        with open(args.svg, "w") as fh:
            fh.write(render_svg(merged, width=args.width))
        print("svg -> %s" % args.svg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
