"""The control of the check that decides `correct`: the reference itself,
computed in bfloat16 (the nearest precision below the float32 that the
configurations state: every stage's output rounded to bfloat16), put in the
program's place for the window's sampled frames.  On the card, at each
cell's own size and load, on three seeds: the check must call it not
correct.  Run on a card with

    python -m pytest efbench/test_efbench_control.py -q -s

(`-s` shows the compared numbers, the control's readings.)  Without a card
the test skips."""

import time

import pytest
import torch

from efbench import harness
from efbench.check import Reference

SEEDS = (2_900_000_011, 3_100_000_013, 3_300_000_017)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _cells():
    return [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", _cells())
def test_the_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in SEEDS:
        r = harness.main(["--workload", workload, "--seed", str(seed), "--seconds", "5",
                          "--trace", "0"], t_start=time.perf_counter(),
                         control=Reference(q=bf16))
        print(f"control {workload} seed {seed}: "
              + " ".join(f"{k}={v['value']!r}" for k, v in r["compared"].items()))
        assert not r["correct"], r["compared"]
