"""Port parity, ``compressed_psum``: the data-parallel wire path (reduce-
scatter in the input dtype, quantize the local sum shard, fold 1/W into the
scales, all-gather codes and scales, dequantize once) on W = 2 and 4 gloo
ranks, against the reference's shard_map run on forced host devices (a
subprocess, as ``tests/test_train.py`` runs it).

Inputs are dyadic (small integers times 2^-5), so every partial sum is
exact and the reduce-scatter's summation order cannot move a bit; the codec
is bitwise. Tolerances and why:
- every rank's result, against the reference's (each device row): EQUAL,
  unpacked and packed, f32 and bf16 inputs, a 6-bit format whose packed
  words straddle codes, rows that do not divide over W (padded) and a
  ragged last block;
- packed against unpacked: EQUAL (the reference's
  ``tests/test_packed.py`` contract: rows never share words);
- against the exact f32 mean: within half the largest grid gap of the
  block's scale (the quantization error of the summed shard), the bound of
  ``tests/test_train.py::test_compressed_psum_matches_mean_8dev``, plus
  half a bf16 ulp of the value for bf16 inputs (the result is cast back to
  the input dtype).
"""
import os
import subprocess
import sys

import _torch_threads  # noqa: F401
import numpy as np
import pytest

import _torch_dist as D
from repro_torch.core.f2p import F2PFormat, Flavor

FMT8 = dict(n_bits=8, h_bits=2, flavor="sr", signed=True)
FMT6 = dict(n_bits=6, h_bits=1, flavor="lr", signed=True)


def _cases(w: int) -> list:
    rng = np.random.default_rng(w)

    def dyadic(shape, lo, hi):
        return (rng.integers(lo, hi, size=(w, *shape)) * 2.0 ** -5).astype(
            np.float32)

    return [("f32_ragged", dyadic((7, 96), -64, 64), "float32", FMT8, 64),
            ("bf16", dyadic((16, 128), -16, 16), "bfloat16", FMT8, 128),
            ("one_dim", dyadic((10,), -64, 64), "float32", FMT8, 128),
            ("six_bit", dyadic((9, 40), -64, 64), "float32", FMT6, 32)]


_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:              # older jax
    from jax.experimental.shard_map import shard_map
import inspect
_smkw = ({"check_vma": False}
         if "check_vma" in inspect.signature(shard_map).parameters
         else {"check_rep": False})
from repro.core.f2p import F2PFormat, Flavor
from repro.optim import CompressionConfig, compressed_psum

with open(sys.argv[1], "rb") as f:
    jobs = pickle.load(f)
out = {}
for w, cases in jobs.items():
    mesh = Mesh(np.array(jax.devices()[:w]), ("d",))
    for tag, arr, dtype, fa, block in cases:
        fmt = F2PFormat(n_bits=fa["n_bits"], h_bits=fa["h_bits"],
                        flavor=Flavor(fa["flavor"]), signed=fa["signed"])
        x = jnp.asarray(arr).astype(dtype)
        for packed in (False, True):
            ccfg = CompressionConfig(fmt=fmt, block=block, packed=packed)
            f = jax.jit(shard_map(
                lambda v: compressed_psum(v[0], "d", ccfg)[None], mesh=mesh,
                in_specs=P("d"), out_specs=P("d"), **_smkw))
            out[(w, tag, packed)] = np.asarray(f(x).astype(jnp.float32))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import pickle

    d = tmp_path_factory.mktemp("psum")
    jobs = {w: _cases(w) for w in (2, 4)}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(jobs, f)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _REFERENCE, str(d / "in.pkl"),
                        str(d / "out.pkl")], capture_output=True, text=True,
                       cwd=root, env=dict(os.environ, PYTHONPATH="src"))
    assert r.returncode == 0, r.stderr[-3000:]
    with open(d / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    port = {w: D.spawn(D.psum_jobs, w, jobs[w]) for w in (2, 4)}
    return jobs, ref, port


@pytest.mark.parametrize("w", [2, 4])
def test_compressed_psum_bitwise_vs_reference(runs, w):
    jobs, ref, port = runs
    for tag, arr, _, _, _ in jobs[w]:
        for packed in (False, True):
            want = ref[(w, tag, packed)]
            for rank, res in enumerate(port[w]):
                np.testing.assert_array_equal(want[rank], want[0])
                np.testing.assert_array_equal(
                    res[(tag, packed)], want[0],
                    err_msg=f"W={w} {tag} packed={packed} rank {rank}")
                assert res[(tag, packed)].shape == arr.shape[1:]


@pytest.mark.parametrize("w", [2, 4])
def test_compressed_psum_packed_equals_unpacked_and_mean(runs, w):
    jobs, _, port = runs
    for tag, arr, dtype, fa, block in jobs[w]:
        res = port[w][0]
        np.testing.assert_array_equal(res[(tag, True)], res[(tag, False)])
        fmt = F2PFormat(**dict(fa, flavor=Flavor(fa["flavor"])))
        exact = arr.astype(np.float64).mean(0)
        ex2 = exact.reshape(exact.shape[0], -1)
        cols = ex2.shape[1]
        npad = -(-cols // block) * block
        blocks = np.pad(np.abs(ex2), ((0, 0), (0, npad - cols))).reshape(
            ex2.shape[0], -1, block).max(-1)
        bound = np.repeat(blocks, block, axis=1)[:, :cols] / \
            fmt.max_value * np.max(np.diff(fmt.grid)) / 2
        if dtype == "bfloat16":   # the cast back: half an ulp, 2^-8
            bound = bound + np.abs(ex2) * 2.0 ** -8
        err = np.abs(res[(tag, False)].reshape(ex2.shape) - ex2)
        assert np.all(err <= bound + 1e-6), (tag, err.max())
