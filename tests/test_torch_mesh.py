"""The multi-device GOP steps (parallel/gop.py's mesh half) on the CPU:
the port's gop_decode_step, gop_encode_step and gop_rebase_chain on a mesh
of repeated CPU devices (one process; the kernels' plain versions) against
the JAX package's shard_map steps on as many of conftest's 8 virtual CPU
devices.  Everything is held bit-exact (tolerance 0) except mean_energy, a
float32 mean whose sum order differs between XLA and PyTorch: rtol 1e-6.
The JAX Pallas kernels run in interpret mode inside its jitted steps.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from alfalfa_tpu.parallel import gop as JG  # noqa: E402

from alfalfa_tpu_torch.parallel import gop  # noqa: E402

import test_mesh_rebase as TM  # noqa: E402

R, C = 2, 3
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures") + os.sep


def _cpu_mesh(n):
    return gop.make_gop_mesh(["cpu"] * n), \
        JG.make_gop_mesh(jax.devices()[:n])


def _untile(t, n, S):
    """JAX's (n, R*C, S*S) tile vectors -> (n, R*S, C*S) planes."""
    return np.asarray(t).reshape(n, R, C, S, S).transpose(0, 1, 3, 2, 4) \
        .reshape(n, R * S, C * S)


def test_gop_decode_step_matches_jax():
    """example_frame_batch (4 frames, inter, B_PRED and whole modes, every
    reference slot) over 2 shards: planes and the gathered exit luma equal
    the JAX step's (tolerance 0), mean_energy to rtol 1e-6 on every
    device; the batch must split evenly."""
    n, B = 2, 4
    mesh, jmesh = _cpu_mesh(n)
    batch = gop.example_frame_batch(B, R, C)
    jbatch = JG.example_frame_batch(B, R, C)
    for a, b in zip(jax.tree_util.tree_leaves(batch),
                    jax.tree_util.tree_leaves(jbatch)):
        np.testing.assert_array_equal(a, b)
    y, u, v, exit_y, energy = gop.gop_decode_step(mesh, R, C)(*batch)
    jy, ju, jv, jexit, jenergy = JG.gop_decode_step(jmesh, R, C)(*jbatch)
    assert [t.shape[0] for t in y] == [B // n] * n
    for got, want in ((y, jy), (u, ju), (v, jv)):
        np.testing.assert_array_equal(torch.cat(got).numpy(),
                                      np.asarray(want))
    assert len(exit_y) == len(energy) == n
    for e, m in zip(exit_y, energy):
        np.testing.assert_array_equal(e.numpy(), np.asarray(jexit))
        assert m.dtype == torch.float32
        np.testing.assert_allclose(float(m), float(jenergy), rtol=1e-6)
    with pytest.raises(ValueError, match="split"):
        gop.gop_decode_step(gop.make_gop_mesh(["cpu"] * 3), R, C)(*batch)


def test_gop_encode_step_matches_jax():
    """Four chunks' seeded key frames through K7's plain version on 2
    shards, two chunks a shard: coefficients and the gathered exit
    reconstructions (each shard's last chunk's) equal the JAX step's (its
    interpret-mode keyframe kernel; tolerance 0)."""
    n, chunks = 2, 4
    mesh, jmesh = _cpu_mesh(n)
    exit_y, coeffs = gop.gop_encode_step(mesh, R, C, chunks)
    jexit, jco = JG.gop_encode_step(jmesh, R, C, chunks)
    assert [c.shape[0] for c in coeffs] == [chunks // n] * n
    np.testing.assert_array_equal(
        torch.cat(coeffs).numpy().reshape(chunks, R * C, 400),
        np.asarray(jco))
    for e in exit_y:
        assert e.shape[0] == n
        np.testing.assert_array_equal(e.numpy(), _untile(jexit, n, 16))


def test_gop_rebase_chain_matches_jax_and_serial():
    """test_mesh_rebase.py's random chain (SPLITMV and whole-vector
    macroblocks, every reference slot), 4 chunks of 2 frames on a ring of
    4 shards of one CPU (four hops through one device, nothing aliased):
    coefficients, nonzero flags and the exit luma equal the JAX ring's and
    test_mesh_rebase.py's serial oracle's (tolerance 0)."""
    n, F = 4, 2
    mesh, jmesh = _cpu_mesh(n)
    inputs, refs0 = TM._chain_inputs(n, F, R, C)
    keep = [np.copy(x) for x in inputs + refs0]
    co, nz, exit_y = gop.gop_rebase_chain(mesh, R, C, F)(*inputs, *refs0)
    for a, b in zip(inputs + refs0, keep):
        np.testing.assert_array_equal(a, b)
    jco, jnz, jexit = JG.gop_rebase_chain(jmesh, R, C, F)(
        *[jnp.asarray(x) for x in inputs], *[jnp.asarray(r) for r in refs0])
    co_ref, nz_ref, exit_ref = TM._serial_oracle(inputs, refs0, R, C)
    co, nz = torch.cat(co).numpy(), torch.cat(nz).numpy()
    assert co.shape == (n, F, R * C, 400)
    for want in (np.asarray(jco), co_ref.reshape(co.shape)):
        np.testing.assert_array_equal(co, want)
    for want in (np.asarray(jnz), nz_ref.reshape(nz.shape)):
        np.testing.assert_array_equal(nz, want)
    for e in exit_y:
        np.testing.assert_array_equal(e.numpy(), np.asarray(jexit))
        np.testing.assert_array_equal(e.numpy(), exit_ref)
    with pytest.raises(ValueError, match="one chunk a device"):
        gop.gop_rebase_chain(mesh[:2], R, C, F)(*inputs, *refs0)


def test_rebase_chain_inputs_from_ivf_matches_jax():
    """rebase_chain_inputs_from_ivf on inter_320x240_q40.ivf (the port's
    Decoder on the CPU) equals the JAX function's arrays (tolerance 0)."""
    path = FIXTURES + "inter_320x240_q40.ivf"
    got, grefs = gop.rebase_chain_inputs_from_ivf(path, 3, 2, device="cpu")
    want, wrefs = JG.rebase_chain_inputs_from_ivf(path, 3, 2)
    for a, b in zip(got + grefs, want + wrefs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_dryrun_multichip_on_cpu_mesh():
    """The port's dry run (decode, encode and rebase steps, the decode step
    on a real interframe against the single-frame Decoder) on four CPU
    shards; the default mesh takes the CUDA devices, none here."""
    gop.dryrun_multichip(4, ["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="at least one device"):
            gop.make_gop_mesh()
