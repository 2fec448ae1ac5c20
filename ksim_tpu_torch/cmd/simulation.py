"""One-shot SchedulerSimulation entrypoint (the reference's KEP-184
scenario-runner container: read a Scenario from a file, run it in a
simulator built from the spec, store the result to a file).

Run: ``python -m ksim_tpu_torch.cmd.simulation sim.yaml [--result out.json]
[--device cuda|cpu]`` (or the ``ksim-torch-simulation`` script).
Exit code 0 on Succeeded, 1 on Failed.

The port of ``ksim_tpu/cmd/simulation.py``: the document runs through
the port's ``run_scheduler_simulation`` on the CUDA card, or on the plain
PyTorch versions with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

from ksim_tpu_torch.cmd import add_device_argument


def run_simulation(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(prog="ksim-torch-simulation")
    ap.add_argument("document", help="SchedulerSimulation YAML/JSON document")
    ap.add_argument(
        "--result", default=None, help="override spec.scenarioResultFilePath"
    )
    add_device_argument(ap)
    args = ap.parse_args(argv)

    import yaml

    from ksim_tpu_torch.scenario.simulation import run_scheduler_simulation

    with open(args.document) as f:
        doc = yaml.safe_load(f)
    if args.result:
        doc.setdefault("spec", {})["scenarioResultFilePath"] = args.result
    out = run_scheduler_simulation(doc, device=args.device)
    status = out.get("status", {})
    json.dump(status, sys.stdout, indent=1)
    print()
    return 0 if status.get("phase") == "Succeeded" else 1


def main() -> None:
    raise SystemExit(run_simulation())


if __name__ == "__main__":
    main()
