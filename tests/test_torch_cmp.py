"""knoxdb_tpu_torch/ops/cmp.py against knoxdb_tpu/ops/cmp.py on the same
seeded limbs: every compare, the set tests, the vector compares and the
mode dispatch, at 1, 2, 4 and 8 limbs. Masks are bool, so the tolerance
is 0. The port carries u32 limbs as int32 (ops/words.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from knoxdb_tpu.ops import cmp as RC
from knoxdb_tpu.types import FilterMode as RFM
from knoxdb_tpu_torch.ops import cmp as TC
from knoxdb_tpu_torch.ops import words as WD
from knoxdb_tpu_torch.types import FilterMode as TFM

SHAPE = (3, 200)
EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)


def _limbs(rng, L, shape=SHAPE):
    """Limbs with many ties in the high limbs and edge words around the
    int32 sign bit, so that the signed carrier must not show."""
    x = EDGES[rng.integers(0, len(EDGES), (L, *shape))]
    x[-1] = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return x


def _w(a):
    return WD.to_words(a, "cpu")


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("L", [1, 2, 4, 8])
@pytest.mark.parametrize("op", ["eq", "ne", "lt", "le", "gt", "ge"])
def test_compare_const(rng, L, op):
    x = _limbs(rng, L)
    for c in (x[:, 1, 7], x[:, 0, 0], _limbs(rng, L, ())):
        _same(getattr(TC, op)(_w(x), _w(c)),
              getattr(RC, op)(jnp.asarray(x), jnp.asarray(c)))


@pytest.mark.parametrize("L", [1, 2, 4, 8])
def test_between_and_sets(rng, L):
    x = _limbs(rng, L)
    lo, hi = x[:, 2, 5], x[:, 1, 9]
    _same(TC.between(_w(x), _w(lo), _w(hi)),
          RC.between(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi)))
    cs = np.stack([x[:, 0, 3], x[:, 2, 100], _limbs(rng, L, ())], axis=1)
    _same(TC.in_set(_w(x), _w(cs)), RC.in_set(jnp.asarray(x),
                                              jnp.asarray(cs)))
    _same(TC.not_in_set(_w(x), _w(cs)),
          RC.not_in_set(jnp.asarray(x), jnp.asarray(cs)))


@pytest.mark.parametrize("L", [1, 2, 4, 8])
@pytest.mark.parametrize("op", ["eq_vec", "lt_vec", "le_vec"])
def test_compare_vec(rng, L, op):
    x, y = _limbs(rng, L), _limbs(rng, L)
    y[:, 0] = x[:, 0]                      # a row of equal values
    _same(getattr(TC, op)(_w(x), _w(y)),
          getattr(RC, op)(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("mode", ["EQ", "NE", "GT", "GE", "LT", "LE",
                                  "RANGE", "IN", "NOT_IN", "TRUE", "FALSE"])
def test_match_dispatch(rng, mode):
    x = _limbs(rng, 2)
    lo, hi = x[:, 0, 1], x[:, 2, 2]
    cs = np.stack([x[:, 0, 3], x[:, 1, 4]], axis=1)
    _same(TC.match(TFM[mode], _w(x), lo=_w(lo), hi=_w(hi), in_limbs=_w(cs)),
          RC.match(RFM[mode], jnp.asarray(x), lo=jnp.asarray(lo),
                   hi=jnp.asarray(hi), in_limbs=jnp.asarray(cs)))


def test_match_rejects_unknown_mode(rng):
    with pytest.raises(ValueError):
        TC.match(TFM.REGEXP, _w(_limbs(rng, 1)))
