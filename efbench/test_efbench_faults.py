"""The check that decides `correct` fails a broken program: a whole run on
the CPU at a small size (the card is not looked for), with the timed path
broken underneath, must print `correct` false; the same run unbroken prints
true.  One run for each fault a SLAM cell on one chip can have:

- a frame that returns its state unchanged;
- half of the frame left out (the lower half of the depth image dropped
  before preprocessing);
- an answer altered where it is produced (the tracked pose moved by 2 mm).

A run that closes loops (the loop-closure test scenario's gates at
160x120) checks its closures' solves and repairs and is correct.  Faults in
the closure layer are not planted here: at this size the scenario's
closures correct less than the limits can see, and no cell of the benchmark
closes loops yet.

A run whose frames or closures go round the harness's hooks (as they would
if the program stopped calling them through the attributes the hooks sit
on) compares fewer of them than it was due to, and is not correct.

No cell exchanges anything between chips, so that fault has no run here.
"""

import pytest

from efbench import harness
from efbench.small import run_small, run_small_loop


def _unhook(monkeypatch, *attrs):
    """Instruments that hook the engine, then lose the hooks on `attrs`
    (dotted paths from the engine): the program's own methods run there."""
    init = harness.Instruments.__init__

    def unhooked(self, eng, samplers, traced):
        init(self, eng, samplers, traced)
        for path in attrs:
            *owner, name = path.split(".")
            obj = eng
            for o in owner:
                obj = getattr(obj, o)
            delattr(obj, name)

    monkeypatch.setattr(harness.Instruments, "__init__", unhooked)


def _correct(**kw) -> bool:
    return run_small(seconds=1.5, **kw)["correct"]


def test_a_sound_run_is_correct():
    r = run_small(seconds=1.5)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0


@pytest.mark.parametrize("workload", ["default-scan", "openloop-scan"])
def test_a_frame_that_leaves_its_state_unchanged_is_not_correct(monkeypatch, workload):
    import elasticfusion_tpu_torch.engine as E

    monkeypatch.setattr(E, "copy_into", lambda dst, src: None)
    assert not _correct(workload=workload)


def test_half_of_the_frame_left_out_is_not_correct(monkeypatch):
    import elasticfusion_tpu_torch.engine as E

    pre = E._preprocess

    def half(depth_mm, cfg):
        d = depth_mm.clone()
        d[d.shape[0] // 2:] = 0
        return pre(d, cfg)

    monkeypatch.setattr(E, "_preprocess", half)
    assert not _correct()


def test_a_pose_altered_where_it_is_produced_is_not_correct(monkeypatch):
    import elasticfusion_tpu_torch.engine as E

    track = E.get_incremental_transformation

    def moved(inputs, cfg, enable=None):
        res = track(inputs, cfg, enable)
        T = res.T_curr.clone()
        T[0, 3] += 0.002
        return res._replace(T_curr=T)

    monkeypatch.setattr(E, "get_incremental_transformation", moved)
    assert not _correct()


def _closures_checked(capsys) -> int:
    """Solves and repairs of the window that the last run checked."""
    err = capsys.readouterr().err
    line = [x for x in err.splitlines() if x.startswith("efbench reference:")][-1]
    words = line.replace(",", "").split()
    return int(words[words.index("solves") - 1]) + int(words[words.index("repairs") - 1])


def test_closures_are_checked_and_a_sound_run_is_correct(capsys):
    r = run_small_loop()
    assert r["correct"], r["compared"]
    assert _closures_checked(capsys) >= 2


def test_frames_that_go_round_the_hooks_are_not_correct(monkeypatch):
    _unhook(monkeypatch, "runner.run")
    r = run_small(seconds=1.5)
    assert not r["correct"]
    assert r["compared"]["frames_unchecked"]["value"] > 0


def test_closures_that_go_round_the_hooks_are_not_correct(monkeypatch):
    _unhook(monkeypatch, "local_deformation.constrain", "global_deformation.constrain",
            "_dispatch_closure")
    r = run_small_loop()
    assert not r["correct"]
    assert r["compared"]["solves_unchecked"]["value"] > 0
    assert r["compared"]["repairs_unchecked"]["value"] > 0
