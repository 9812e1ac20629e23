"""The multi-device dry run: every sharded path of the port on one mesh,
each held against its host golden.

Port of the JAX package's ``__graft_entry__.dryrun_multichip``. There one
``shard_map`` step runs the dp-sharded MiMC, the dp-sharded f128 inverse NTT
and a bucket ``psum`` over both mesh axes on a virtual CPU mesh, and then
the library's own sharded paths run: ``mimc_hash_batch(mesh=)``,
``msm_many_sharded`` and the four-step ``ntt_sharded``. Here the step runs
position by position on a :class:`~.mesh.Mesh` of ``torch.device``s.
"""

from __future__ import annotations

import random

import torch

from ..device import resolve
from ..ops import ed25519 as ed
from ..ops.curve import DeviceTable, msm_many_sharded
from ..ops.field import BN254_FR, F128
from ..ops.limb import get_context
from ..ops.mimc import mimc_batch_device, mimc_hash_batch, mimc_hash_native
from ..ops.ntt import ntt_device, ntt_py, ntt_sharded
from ..ops.weierstrass import get_engine
from . import collective
from .mesh import dp_sharding, get_mesh

N_TRACE = 8  # the STARK trace length of the improvement proofs


def _fail(what: str) -> None:
    raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, *, device=None) -> dict:
    """Run every sharded path on a mesh of ``n_devices`` positions and hold
    each against its host golden; raises ``AssertionError`` on the first
    difference, else returns what ran.

    The positions are ``n_devices`` CUDA cards where that many are visible,
    else ``device`` (default the CUDA card; ``"cpu"`` for the plain
    versions) repeated: such a mesh checks the sharding and the per-block
    work and measures no interconnect. ``shard`` is 2 where ``n_devices`` is
    even (and above 1), else 1; ``dp`` is ``n_devices // shard``. It runs:

    * the dp-sharded MiMC of ``2 * dp`` values (each position hashes its dp
      block, as every shard position of the JAX step does);
    * the dp-sharded f128 inverse NTT of ``2 * dp`` traces of 8;
    * the limb-wise bucket sum of the digests, ``psum`` over ``shard`` then
      ``dp``;
    * ``mimc_hash_batch(..., mesh=)``;
    * ``msm_many_sharded`` of ed25519 MSMs over a 4-point basis;
    * ``ntt_sharded``, forward and inverse, on f128 and BN254 Fr at N =
      max(64, shard^2), where shard is 2 or more.
    """
    dev = resolve(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    shard = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    dp = n_devices // shard
    mesh = get_mesh(dp=dp, shard=shard, devices=devices)
    fr = get_context(BN254_FR.p, "bn254_fr")
    f128 = get_context(F128.p, "f128")
    batch = dp * 2  # two ops a dp block
    numbers = list(range(1, batch + 1))
    want = [mimc_hash_native(v) for v in numbers]
    traces = [list(range(i, i + N_TRACE)) for i in range(batch)]

    # the sharded step, position by position
    place = dp_sharding(mesh)
    digests = tuple(tuple(mimc_batch_device(v) for v in row) for row in place.put(fr.encode(numbers)))
    polys = torch.stack([f128.encode(t) for t in traces])
    tr_ntt = tuple(tuple(f128.from_mont(ntt_device(f128, f128.to_mont(t), invert=True)) for t in row)
                   for row in place.put(polys))
    partial = tuple(tuple(d.sum(dim=0, keepdim=True) for d in row) for row in digests)
    bucket = collective.psum(collective.psum(partial, "shard", mesh=mesh), "dp", mesh=mesh)

    for name, parts in (("MiMC", digests), ("inverse NTT", tr_ntt)):
        if any(not torch.equal(p.cpu(), row[0].cpu()) for row in parts for p in row):
            _fail(f"the shard positions of a dp row disagree on the sharded {name}")
    got = fr.decode(torch.cat([row[0].cpu() for row in digests]))
    if got != want:
        _fail("the sharded MiMC differs from the host golden")
    got_ntt = torch.cat([row[0].cpu() for row in tr_ntt])
    if [f128.decode(t) for t in got_ntt] != [ntt_py(F128, t, invert=True) for t in traces]:
        _fail("the sharded f128 inverse NTT differs from the host golden")
    limb_sum = shard * torch.cat([row[0].cpu() for row in digests]).to(torch.int64).sum(dim=0)
    if any(not torch.equal(b.cpu()[0].to(torch.int64), limb_sum) for row in bucket for b in row):
        _fail("the bucket psum over shard and dp differs from the host sum")

    # the library's own sharded paths
    if mimc_hash_batch(numbers, device=devices[0], mesh=mesh) != want:
        _fail("mimc_hash_batch on the mesh differs from the host golden")
    rng = random.Random(42)
    K, B = 4, max(4, dp)
    pts = [ed.from_uniform_bytes(rng.randbytes(64)) for _ in range(K)]
    vecs = [[rng.randrange(ed.L) for _ in range(K)] for _ in range(B)]
    table = DeviceTable(get_engine("ed25519").encode_points(pts), device=devices[0], curve="ed25519")
    for sv, g in zip(vecs, msm_many_sharded(table, vecs, mesh), strict=True):
        if not ed.point_equal(tuple(g), ed.msm(sv, pts)):
            _fail("msm_many_sharded differs from the host MSM")
    ntt_sizes = []
    if shard >= 2:
        n = max(64, shard * shard)
        for F in (F128, BN254_FR):
            vals = [(i * 7919 + 13) % F.p for i in range(n)]
            fwd = ntt_sharded(F.p, vals, mesh)
            if fwd != ntt_py(F, vals):
                _fail(f"the four-step NTT over {F.name} differs from ntt_py (forward)")
            if ntt_sharded(F.p, fwd, mesh, invert=True) != vals:
                _fail(f"the four-step NTT over {F.name} differs from ntt_py (inverse)")
        ntt_sizes.append(n)
    return {"devices": [str(d) for d in devices], "mesh": mesh.shape, "batch": batch,
            "msm_lanes": B, "ntt_sharded_n": ntt_sizes}
