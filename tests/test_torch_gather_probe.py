"""The probe's windowed row gather in the PyTorch port vs the JAX probe
``benchmarks/pallas_gather_probe.py``: the port's ``prepare`` +
``window_gather`` (its plain version, on CPU tensors) must equal each of the
three Pallas bodies, run in TPU interpret mode, and ``xla_take`` exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from benchmarks.pallas_gather_probe import (
    _loop_body,
    _onehot_body,
    _take_body,
    make_inputs as jmake_inputs,
    pallas_gather,
    xla_take,
)
from pointmvsnet_tpu_torch.benchmarks.pallas_gather_probe import make_inputs, run
from pointmvsnet_tpu_torch.ops.window_gather import (
    prepare,
    window_gather,
    window_gather_cuda,
)
from torch_threads import one_torch_thread  # noqa: F401

N, WIDTH, SPAN, ROWS = 2048, 128, 1024, 2000
BODIES = {"onehot": _onehot_body, "loop": _loop_body, "take": _take_body}


def port_gather(table, idx, span):
    table_p, q, rel = prepare(torch.tensor(table), torch.tensor(idx), span)
    return window_gather(table_p, q, rel, span).numpy(), rel.numpy()


@pytest.fixture(scope="module")
def inputs():
    table, idx = jmake_inputs(ROWS, N, WIDTH)
    return np.asarray(table), np.asarray(idx)


def test_make_inputs_is_the_probes(inputs):
    table, idx = make_inputs(ROWS, N, WIDTH)
    np.testing.assert_array_equal(table, inputs[0])
    np.testing.assert_array_equal(idx, inputs[1])


@pytest.mark.parametrize("body", sorted(BODIES))
def test_equals_pallas_body(inputs, body):
    table, idx = inputs
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_gather(jnp.asarray(table), jnp.asarray(idx), SPAN,
                                        BODIES[body]))
    got, rel = port_gather(table, idx, SPAN)
    assert (rel >= SPAN).any(), "no row in the upper slab: the case is too easy"
    np.testing.assert_array_equal(got, want)


def test_equals_xla_take(inputs):
    table, idx = inputs
    want = np.asarray(xla_take(jnp.asarray(table), jnp.asarray(idx), SPAN))
    got, _ = port_gather(table, idx, SPAN)
    np.testing.assert_array_equal(got, want)


def test_upper_slab_and_last_block():
    """Rows in the upper slab of every window, and a last block whose
    window reaches into the padding after the table's last row."""
    rng = np.random.RandomState(7)
    rows = 3000
    table = rng.randn(rows, 8).astype(np.float32)
    idx = np.concatenate([
        np.arange(1023, 1023 + 512),               # q 0, rel 1023..1534
        rng.randint(1500, 2400, 512),              # q 1, partly the upper slab
        rows - 1 - rng.randint(0, 400, 512),       # last block, up to row 2999
        np.full(512, rows - 1),                    # one row repeated
    ]).astype(np.int32)
    got, rel = port_gather(table, idx, SPAN)
    assert (rel >= SPAN).sum() > 512
    np.testing.assert_array_equal(got, table[idx])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_gather(jnp.asarray(table), jnp.asarray(idx), SPAN,
                                        _onehot_body))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", [-1, 2 * SPAN])
def test_raises_on_rel_outside_window(inputs, bad):
    table, idx = inputs
    table_p, q, rel = prepare(torch.tensor(table), torch.tensor(idx), SPAN)
    rel[5] = bad
    with pytest.raises(ValueError, match="two-slab window"):
        window_gather(table_p, q, rel, SPAN)


def test_raises_on_indices_too_spread():
    """A block whose indices span more than SPAN rows cannot use the
    window: the gather refuses it rather than reading the wrong rows."""
    table = np.zeros((4096, 4), np.float32)
    idx = np.concatenate([np.zeros(256), np.full(256, 3000)]).astype(np.int32)
    table_p, q, rel = prepare(torch.tensor(table), torch.tensor(idx), SPAN)
    with pytest.raises(ValueError):
        window_gather(table_p, q, rel, SPAN)


def test_cuda_wrapper_refuses_cpu_tensors(inputs):
    table, idx = inputs
    table_p, q, rel = prepare(torch.tensor(table), torch.tensor(idx), SPAN)
    with pytest.raises(ValueError, match="CUDA"):
        window_gather_cuda(table_p, q, rel, SPAN)


def test_probe_entry_point_on_cpu():
    res = run(n=1024, width=16, span=1024, n_rows_table=1500, device="cpu", iters=1,
              verbose=False)
    assert sorted(res) == ["index_select", "kernel", "plain"]
    assert all(r["exact"] for r in res.values())
