"""``pointmvsnet_tpu_torch/bench.py::device_line``, the card's name and
power limit that stand beside every number the port measures, on a fake
host of two cards: ``subprocess.run`` answers as ``nvidia-smi`` does (every
card in PCI order, whatever ``CUDA_VISIBLE_DEVICES`` says; one card when
asked by ``--id``), and ``torch.cuda`` numbers only the visible cards from
0. The port's CPU tests have no card, so both are stubbed."""

import subprocess
import types

import pytest
import torch

from pointmvsnet_tpu_torch import bench

# PCI order: what nvidia-smi lists; torch's index 0 under CUDA_VISIBLE_DEVICES=1 is card 1
CARDS = [("2b9a1c6e-0000-4000-8000-00000000000a", "NVIDIA H100 80GB HBM3", "700.00 W"),
         ("7f31d0c4-0000-4000-8000-00000000000b", "NVIDIA H100 80GB HBM3", "350.00 W")]


def fake_smi(calls, returncode=0, stderr=""):
    def run(cmd, **kwargs):
        calls.append(cmd)
        assert cmd[0] == "nvidia-smi" and kwargs.get("timeout")
        ids = [a.split("=", 1)[1] for a in cmd if a.startswith("--id=")]
        rows = [c for c in CARDS if not ids or f"GPU-{c[0]}" in ids]
        out = "".join(f"{name}, {limit}\n" for _, name, limit in rows)
        return subprocess.CompletedProcess(cmd, returncode, "" if returncode else out, stderr)
    return run


@pytest.fixture
def two_cards(monkeypatch):
    """CUDA_VISIBLE_DEVICES=1 on the fake host: torch sees one card, card 1."""
    visible = (1,)                       # torch's index → the card's place in PCI order
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1")

    def props(device=None):
        idx = torch.device(device).index if device is not None else 0
        uuid, name, _ = CARDS[visible[idx or 0]]
        return types.SimpleNamespace(uuid=uuid, name=name)

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: props(device).name)
    calls = []
    monkeypatch.setattr(bench.subprocess, "run", fake_smi(calls))
    return calls


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_device_line_names_the_visible_card(two_cards, device):
    line = bench.device_line(torch.device(device))
    assert line == "NVIDIA H100 80GB HBM3, 350.00 W"          # card 1's, not card 0's
    assert len(two_cards) == 1 and f"--id=GPU-{CARDS[1][0]}" in two_cards[0]
    assert "--query-gpu=name,power.limit" in two_cards[0]


def test_device_line_keeps_a_uuid_that_has_its_prefix(two_cards, monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(uuid=f"GPU-{CARDS[1][0]}"))
    assert bench.device_line(torch.device("cuda")) == "NVIDIA H100 80GB HBM3, 350.00 W"
    assert f"--id=GPU-{CARDS[1][0]}" in two_cards[0]


def test_device_line_failure_messages(two_cards, monkeypatch):
    calls = []
    monkeypatch.setattr(bench.subprocess, "run",
                        fake_smi(calls, returncode=6, stderr="No devices were found\n"))
    assert bench.device_line(torch.device("cuda")) == \
        "NVIDIA H100 80GB HBM3; nvidia-smi failed: No devices were found"

    def missing(cmd, **kwargs):
        raise FileNotFoundError(2, "No such file or directory", "nvidia-smi")

    monkeypatch.setattr(bench.subprocess, "run", missing)
    assert bench.device_line(torch.device("cuda")) == (
        "NVIDIA H100 80GB HBM3; nvidia-smi failed: "
        "[Errno 2] No such file or directory: 'nvidia-smi'")

    def slow(cmd, **kwargs):
        raise subprocess.TimeoutExpired(cmd, kwargs["timeout"])

    monkeypatch.setattr(bench.subprocess, "run", slow)
    assert bench.device_line(torch.device("cuda")).startswith(
        "NVIDIA H100 80GB HBM3; nvidia-smi failed: Command '['nvidia-smi', ")
    assert bench.device_line(torch.device("cpu")) == "cpu"
