"""The PyTorch port stands apart from JAX, from the JAX package and from
Triton, and its CUDA launchers refuse CPU tensors before anything is built
or launched."""

import os
import subprocess
import sys

import pytest
import torch

from lambdaworks_cairo_prover_tpu_torch import cuda_lib
from lambdaworks_cairo_prover_tpu_torch.field import cuda_field as cf
from lambdaworks_cairo_prover_tpu_torch.field import device as tfd
from lambdaworks_cairo_prover_tpu_torch.hash import cuda_keccak as ck
from lambdaworks_cairo_prover_tpu_torch.ntt import core as tnttc
from lambdaworks_cairo_prover_tpu_torch.ntt import cuda_ntt as cn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import lambdaworks_cairo_prover_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) > 50, names
for mod in ("cli", "interop", "air.trace", "cairo.air", "cairo.cairo_mem",
            "cairo.decode", "cairo.execution_trace", "cairo.native",
            "cairo.programs", "cairo.register_states", "cairo.runner",
            "cairo.vm", "cairo.builtins", "cairo.hints", "cairo.hints_stdlib",
            "cairo.stdlib", "cairo.casm", "air.examples.fibonacci_2_columns",
            "air.examples.quadratic_air", "air.examples.fibonacci_rap",
            "air.examples.dummy_air", "ntt.poly_host", "prover.debug",
            "parallel.sharding", "parallel.four_step",
            "parallel.sharded_kernels"):
    assert pkg.__name__ + "." + mod in names, mod
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton",
                                    "lambdaworks_cairo_prover_tpu"))
assert not bad, bad
print("imported", len(names))
"""


def test_every_module_imports_without_jax_or_triton():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("imported")


def _limbs(*shape):
    return torch.zeros((16,) + shape, dtype=torch.int32)


def _packed(n):
    return torch.zeros((n, 8), dtype=torch.int32)


@pytest.mark.parametrize("launch", [
    lambda: cf.mont_mul(_limbs(8), _limbs(8)),
    lambda: cf.add_sub_mod(_limbs(8), _limbs(8), "add"),
    lambda: cf.add_sub_mod(_limbs(8), _limbs(8), "sub"),
    lambda: cn.ntt_dif_stages(_limbs(1, 16), _limbs(1, 16), _packed(16), 3, 2),
    lambda: cn.ntt_dif_local(_limbs(1, 16), _limbs(1, 16), _packed(16), 4, True),
    lambda: ck.keccak_rows(_limbs(3, 8)),
    lambda: ck.keccak_pairs(torch.zeros((8, 4), dtype=torch.int64)),
    lambda: ck.keccak_grind((1, 2, 3, 4), 0, 64, 3, "cpu"),
], ids=["mont_mul", "add", "sub", "ntt_dif_stages", "ntt_dif_local",
        "keccak_rows", "keccak_pairs", "keccak_grind"])
def test_cuda_launchers_refuse_cpu_tensors(launch):
    counts = _launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        launch()
    assert "lib" not in cuda_lib._state  # nothing was built or loaded
    assert counts == _launch_counts()


def _launch_counts() -> tuple:
    return tuple(w.launches for w in (
        cf.mont_mul, cf.add_sub_mod, cn.ntt_dif_stages, cn.ntt_dif_local,
        ck.keccak_rows, ck.keccak_pairs, ck.keccak_grind))


def test_public_ops_take_the_plain_path_on_cpu():
    counts = (cf.mont_mul.launches, cf.add_sub_mod.launches,
              cn.ntt_dif_stages.launches, cn.ntt_dif_local.launches)
    x = tfd.from_ints(list(range(1, 17)), device="cpu")
    y = tfd.add(tfd.mul(x, x), tfd.sub(x, tfd.neg(x)))
    assert tfd.to_ints(y) == [k * k + 2 * k for k in range(1, 17)]
    assert torch.equal(tnttc.intt(tnttc.ntt(x)), x)
    assert counts == (cf.mont_mul.launches, cf.add_sub_mod.launches,
                      cn.ntt_dif_stages.launches, cn.ntt_dif_local.launches)
    assert "lib" not in cuda_lib._state
