"""The control of ``correct``: the plain reference computed in fp8 (the
precision below the configurations' bfloat16) put in the program's place
has to come out as not correct, as has half of a training step's batch
left out, a frame with its colour channels reversed, and a reply built
from another request: the frame of another pose or another style. At a tiny size on the
CPU, and (marked ``cuda``) at the cells' own size on the card."""

import pytest
import torch

from crbench import control
from crbench.harness import load_json

from tinycell import tiny_cell


def fails(readings, limits):
    """Whether a compared number reads above its limit."""
    return any(readings[k] > lim for k, lim in limits.items())


def cell(name, tiny: bool):
    if tiny:
        wl, cfg = tiny_cell(name, compute_dtype="bfloat16")
    else:
        wl = load_json("workloads", name + ".json")
        cfg = load_json("configs", wl["config"] + ".json")
    return {**cfg["fields"], **wl.get("runtime", {})}, wl


def check_train(device, tiny):
    fields, wl = cell("train_stash_g1", tiny)
    got = control.train_readings(fields, wl, 2 ** 31 + 5, device)
    print(got)
    assert fails(got["control_fp8"], wl["limits"]), got
    assert fails(got["half_batch"], wl["limits"]), got


def check_serve(device, tiny):
    fields, wl = cell("serve_320x240_c4", tiny)
    got = control.serve_readings(fields, wl, 2 ** 31 + 6, device,
                                 n_frames=1)
    print(got)
    assert fails(got["control_fp8"], wl["limits"]), got
    assert fails(got["channels_reversed"], wl["limits"]), got
    assert fails(got["other_pose"], wl["limits"]), got
    assert fails(got["other_style"], wl["limits"]), got


def test_train_control_fails_at_a_tiny_size():
    check_train(torch.device("cpu"), tiny=True)


def test_serve_control_fails_at_a_tiny_size():
    check_serve(torch.device("cpu"), tiny=True)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cells' size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_train_control_fails_at_the_cell_size(card):
    check_train(card, tiny=False)


@pytest.mark.cuda
def test_serve_control_fails_at_the_cell_size(card):
    check_serve(card, tiny=False)
