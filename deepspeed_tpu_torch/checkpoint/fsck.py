"""Offline validator of the durable-commit protocol.

Counterpart of the JAX package's ``scripts/ds_ckpt_fsck.py``, as a module
of the port (which cannot import the JAX script): it audits a checkpoint
root as the engine's load-time fallback does, touching no device and
restoring no state.  Usage::

    python -m deepspeed_tpu_torch.checkpoint.fsck <checkpoint_root> [--json] [--deep]

Reports, per tag: status (committed / no_marker / bad_manifest / partial /
legacy), global step, payload file count and bytes, and whether ``latest``
resolves to a committed tag; ``--deep`` re-reads every manifest-listed
payload file.  Exit code: 0 when ``latest`` (or the newest tag, with no
pointer) is committed or legacy; 1 otherwise; 2 on usage errors.
"""

import argparse
import json
import os
import sys

from deepspeed_tpu_torch.runtime.resilience import (COMMITTED, LEGACY,
                                                    TMP_SUFFIX, scan_tags)


def _deep_check(root, tag, manifest):
    """Re-read every manifest-listed payload file; the problems found."""
    problems = []
    for rec in (manifest or {}).get("files", []):
        path = os.path.join(root, tag, rec["path"])
        try:
            remaining = rec["bytes"]
            with open(path, "rb") as f:
                while remaining > 0:
                    chunk = f.read(min(remaining, 1 << 20))
                    if not chunk:
                        problems.append(f"{rec['path']}: short read")
                        break
                    remaining -= len(chunk)
        except OSError as e:
            problems.append(f"{rec['path']}: {e}")
    return problems


def fsck(root, deep=False):
    """Audit one checkpoint root: a report dict (the --json payload) with
    every tag's status and the resolved ``latest`` pointer."""
    tags = []
    for name, status, manifest in scan_tags(root):
        files = (manifest or {}).get("files", [])
        entry = {"tag": name, "status": status,
                 "global_step": (manifest or {}).get("global_step"),
                 "files": len(files),
                 "bytes": sum(f["bytes"] for f in files)}
        if deep and status == COMMITTED:
            problems = _deep_check(root, name, manifest)
            if problems:
                entry["status"] = "unreadable"
                entry["problems"] = problems
        tags.append(entry)
    stale_tmp = sorted(
        n for n in (os.listdir(root) if os.path.isdir(root) else [])
        if n.startswith(".") and n.endswith(TMP_SUFFIX))
    latest_tag = None
    latest_path = os.path.join(root, "latest")
    if os.path.exists(latest_path):
        with open(latest_path) as f:
            latest_tag = f.read().strip()
    by_tag = {t["tag"]: t for t in tags}
    if latest_tag is not None:
        latest_status = by_tag.get(latest_tag, {}).get("status", "missing")
    else:
        latest_status = tags[0]["status"] if tags else "missing"
    return {"root": os.path.abspath(root), "tags": tags,
            "stale_tmp_dirs": stale_tmp, "latest": latest_tag,
            "latest_status": latest_status,
            "ok": latest_status in (COMMITTED, LEGACY)}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="validate checkpoint tags offline")
    parser.add_argument("root", help="checkpoint directory (contains tags)")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable report on stdout")
    parser.add_argument("--deep", action="store_true",
                        help="re-read every payload file, not just sizes")
    args = parser.parse_args(argv)
    if not os.path.isdir(args.root):
        print(f"error: {args.root} is not a directory", file=sys.stderr)
        return 2
    report = fsck(args.root, deep=args.deep)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(f"checkpoint root: {report['root']}")
        for t in report["tags"]:
            step = t["global_step"]
            step_s = f"step {step}" if step is not None else "step ?"
            print(f"  {t['tag']:<32} {t['status']:<13} {step_s:<12} "
                  f"{t['files']} file(s), {t['bytes']} byte(s)")
            for p in t.get("problems", []):
                print(f"      ! {p}")
        for n in report["stale_tmp_dirs"]:
            print(f"  {n:<32} stale-tmp (crashed/aborted save)")
        if report["latest"] is not None:
            print(f"latest -> {report['latest']} ({report['latest_status']})")
        else:
            print("no 'latest' pointer")
        print("OK" if report["ok"] else "NOT OK: newest checkpoint is not "
              "committed -- the engine will fall back at load time")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
