"""K3's body choice and its plain twin at the widths the card tests use.

``spmv_stencil5_const`` launches K3's vector body on a card when ``const_vector_fits`` holds
and the scalar body otherwise (``tpusparse_torch/csrc/stencil5_const.cu``).  The rule is a
plain function of shapes, strides and addresses, so it is held here on CPU tensors: rows
of whole 16-byte vectors (g·itemsize a multiple of 16) and x, the halo rows and ``out``
contiguous on 16-byte boundaries.  CPU tensors start on 64-byte boundaries, so a view k
elements into its storage lies k·itemsize bytes past one.

The twin, which both bodies must equal bit for bit on a card (tests/test_torch_cuda.py),
is held against the JAX package's ``spmv_stencil5_const_pipelined`` in Pallas interpret
mode with ``block_rows=8`` (as tests/test_torch_stencil5.py runs it), at the card tests'
widths, on bands of 1 and 9 rows with and without halo rows: f64 to 1e-12, f32 to
1e-5 (the dot sums in another order), bf16 fields bit for bit and the f32 dot to 1e-2
(JAX rounds each grid block's partial to bf16; ``kernels/_launch.py``); a dot's tolerance
is relative to the sum of its terms' magnitudes, which bounds what the order can move.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusparse.kernels import stencil5 as jst5
from tpusparse_torch.kernels import stencil5 as st5

WIDTHS = [1, 7, 8, 9, 37, 64, 1000, 4096]
ROWS = [1, 9]  # one slab (the one-row piece), and two of the pipelined kernel's
KW = {"diag": 5.0, "offdiag": -1.0}
JKW = {"diag": 5.0, "offdiag": -1.0, "block_rows": 8, "interpret": True}
STATES = {"f32": (torch.float32, jnp.float32), "f64": (torch.float64, jnp.float64),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
# (field tolerance, dot tolerance), relative to the largest reference magnitude
TOL = {"f32": (1e-5, 1e-5), "f64": (1e-12, 1e-12), "bf16": (0.0, 1e-2)}


def _view(dtype, shape, offset=0):
    """A contiguous CPU field of ``shape`` that lies ``offset`` elements into its storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


# (state, g, x's offset in elements, which other operand is offset by one element or
# None) -> whether the vector body takes it
PREDICATE_CASES = [
    # rows of whole 16-byte vectors: 8 f32, 2 f64, 8 bf16 elements at the least
    ("f32", 8, 0, None, True), ("f32", 4, 0, None, True), ("f32", 1000, 0, None, True),
    ("f32", 30, 0, None, False), ("f32", 37, 0, None, False), ("f32", 2, 0, None, False),
    ("f64", 30, 0, None, True), ("f64", 2, 0, None, True), ("f64", 37, 0, None, False),
    ("f64", 1, 0, None, False), ("bf16", 8, 0, None, True), ("bf16", 4096, 0, None, True),
    ("bf16", 30, 0, None, False), ("bf16", 4, 0, None, False),
    # x off a 16-byte boundary, or a whole vector in (on one again)
    ("f32", 8, 1, None, False), ("f32", 8, 4, None, True), ("f32", 8, 2, None, False),
    ("f64", 2, 1, None, False), ("f64", 2, 2, None, True), ("bf16", 8, 1, None, False),
    ("bf16", 8, 4, None, False), ("bf16", 8, 8, None, True),
    # a halo row or out off a 16-byte boundary
    ("f32", 8, 0, "halo_prev", False), ("f32", 8, 0, "halo_next", False),
    ("f64", 2, 0, "out", False), ("bf16", 8, 0, "halo_next", False),
    ("bf16", 8, 0, "out", False),
]


@pytest.mark.parametrize("state,g,x_offset,shifted,want", PREDICATE_CASES)
def test_vector_rule_follows_shapes_and_offsets(state, g, x_offset, shifted, want):
    dtype = STATES[state][0]
    ops = {"halo_prev": _view(dtype, (1, g)), "halo_next": _view(dtype, (1, g)),
           "out": _view(dtype, (5, g))}
    if shifted is not None:
        ops[shifted] = _view(dtype, ops[shifted].shape, 1)
    x = _view(dtype, (5, g), x_offset)
    assert st5.const_vector_fits(x, **ops) is want
    if not shifted:  # each optional operand may be absent
        assert st5.const_vector_fits(x) is want


# (kernel, state, g, which operand lies off by ``shift`` elements or None, shift) ->
# whether its vector body takes the launch: K1 reads r and p and writes out (p'), K2 reads
# and writes x and r and reads p, each with the halo rows
RECOMPUTE_OPERANDS = {"K1": ("r", "p", "out", "halo_prev", "halo_next"),
                      "K2": ("x", "r", "p", "halo_prev", "halo_next")}
RECOMPUTE_CASES = [
    # rows of whole 16-byte vectors: 4 f32, 2 f64 elements at the least
    *((k, "f32", g, None, 0, g % 4 == 0) for k in RECOMPUTE_OPERANDS for g in (4, 64, 1000,
                                                                             2, 37)),
    *((k, "f64", g, None, 0, g % 2 == 0) for k in RECOMPUTE_OPERANDS for g in (2, 32, 37, 1)),
    # each operand one element off a 16-byte boundary, or a whole vector in (on one again)
    *((k, state, g, name, shift, shift * size % 16 == 0)
      for k, names in RECOMPUTE_OPERANDS.items() for name in names
      for state, g, size in (("f32", 8, 4), ("f64", 4, 8))
      for shift in (1, 16 // size)),
]


def _recompute_fits(kernel, ops):
    """The wrapper's rule for K1's or K2's operands (kernels/stencil5.py)."""
    if kernel == "K1":
        return st5.const_vector_fits(ops["r"], ops["halo_prev"], ops["halo_next"], ops["out"],
                                     fields=(ops["p"],))
    return st5.const_vector_fits(ops["r"], ops["halo_prev"], ops["halo_next"],
                                 fields=(ops["x"], ops["p"]))


@pytest.mark.parametrize("kernel,state,g,shifted,shift,want", RECOMPUTE_CASES)
def test_recompute_vector_rule_follows_shapes_and_offsets(kernel, state, g, shifted, shift,
                                                          want):
    dtype = STATES[state][0]
    ops = {name: _view(dtype, (1, g) if name.startswith("halo") else (5, g))
           for name in RECOMPUTE_OPERANDS[kernel]}
    if shifted is not None:
        ops[shifted] = _view(dtype, ops[shifted].shape, shift)
    assert _recompute_fits(kernel, ops) is want
    if shifted is None or shifted.startswith("halo"):  # the halo rows may be absent
        assert _recompute_fits(kernel, {**ops, "halo_prev": None, "halo_next": None}) is \
            (want if shifted is None else True)


@pytest.mark.parametrize("state", list(STATES))
def test_vector_rule_refuses_what_the_kernels_cannot_read(state):
    """A transposed (non-contiguous) field or halo row, a 1-D or 3-D field, and float16."""
    dtype = STATES[state][0]
    x = _view(dtype, (16, 16))
    assert st5.const_vector_fits(x)
    assert not st5.const_vector_fits(x.t())
    assert not st5.const_vector_fits(x, _view(dtype, (16, 2))[:, 0].reshape(1, 16))
    assert not st5.const_vector_fits(x.reshape(-1))
    assert not st5.const_vector_fits(x.reshape(2, 8, 16))
    assert not st5.const_vector_fits(x.half())


def _fields(seed, rows, g, jdtype):
    """x, halo_prev, halo_next from a seed, rounded to the state's dtype (bf16 values are
    then exact in both packages)."""
    rng = np.random.RandomState(seed)
    return [np.array(jnp.asarray(rng.randn(*s), jdtype).astype(jnp.float64))
            for s in ((rows, g), (1, g), (1, g))]


@pytest.mark.parametrize("g", WIDTHS)
@pytest.mark.parametrize("state", list(STATES))
def test_twin_matches_pallas_at_card_widths(g, state):
    dtype, jdtype = STATES[state]
    tol_field, tol_dot = TOL[state]
    for rows in ROWS:
        x, hp, hn = _fields(1000 * g + rows, rows, g, jdtype)
        for halos in ((), (hp, hn)):
            yj, dj = jst5.spmv_stencil5_const_pipelined(
                *(jnp.asarray(a, jdtype) for a in (x, *halos)), with_dot=True, **JKW)
            y, d = st5.spmv_stencil5_const(
                *(torch.from_numpy(a).to(dtype) for a in (x, *halos)), with_dot=True, **KW)
            assert y.dtype == dtype and y.shape == (rows, g)
            yj = np.asarray(jnp.asarray(yj, jnp.float64))
            y = y.double().numpy()
            scale = max(np.abs(yj).max(), 1e-300)
            what = (rows, len(halos))
            if tol_field == 0.0:
                np.testing.assert_array_equal(y, yj, err_msg=str(what))
            else:
                assert np.abs(y - yj).max() <= tol_field * scale, what
            # a summation order moves a dot by at most its terms' magnitudes' sum times
            # the rounding unit
            terms = float(np.abs(x * yj).sum())
            assert abs(float(d) - float(dj)) <= tol_dot * max(terms, 1e-300), what
