"""Drive the PyTorch / CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py              # every phase
    python3 chip_smoke.py --kernels    # phases 1 to 3 only, no last line
    python3 chip_smoke.py --range      # phases 1, 2 and 4 only, no last line
    python3 chip_smoke.py --groth16    # phases 1, 2, 5 and 6 only, no last line
    python3 chip_smoke.py --g1         # phases 1, 2 and g1_pair only, no last line
    python3 chip_smoke.py --mont       # phases 1, 2, mont_pair and 10 only, no last line
    python3 chip_smoke.py --ed-tree    # phases 1, 2 and ed_tree_pair only, no last line
    python3 chip_smoke.py --ed-pair    # phases 1, 2 and ed_pair only, no last line
    python3 chip_smoke.py --f32-chain  # phases 1, 2 and f32_chain only, no last line
    python3 chip_smoke.py --ed-chain   # phases 1, 2 and ed_chain only, no last line
    python3 chip_smoke.py --mont-padd  # phases 1, 2 and mont_padd only, no last line
    python3 chip_smoke.py --fe-mul     # phases 1, 2 and fe_mul only, no last line
    python3 chip_smoke.py --bp-rest    # phases 1, 2 and 13 only, no last line
    python3 chip_smoke.py --native     # phases 1, 2 and 12 only, no last line
    python3 chip_smoke.py --membership # phases 1, 2 and 6b only, no last line
    python3 chip_smoke.py --improvement  # phases 1, 2, mont_mul's and blake3's checks (3e, 3g) and 6c only
    python3 chip_smoke.py --api        # phases 1, 2 and 6d only, no last line
    python3 chip_smoke.py --multi-device  # phases 1, 2 and 10b only, no last line
    python3 chip_smoke.py --device-hash   # phases 1, 2, blake3's checks (3g) and 6e only, no last line
    python3 chip_smoke.py --ristretto  # phases 1, 2 and 6f only, no last line

Phases, each printing one JSON line:

1. the card (``nvidia-smi`` and torch's view of it);
2. the build of the CUDA kernels from ``libzkp_tpu_torch/csrc`` (timed; the
   ptxas lines, and the registers, frame and spills of mont_mul, tree_sum
   ed25519, pair_add ed25519, padd_f32_chain, padd_chain, mont_padd, fe_mul
   and blake3), and beside it ``g++``'s build of the native host tier
   (``libzkp_tpu_torch/native``: its seconds, flags and library);
3. each kernel instance against its plain PyTorch version on the card at its
   path's shapes, both timed with CUDA events: the ed25519 window_sum,
   horner and pair_add of the range prover; pair_add, window_sum4 and
   horner4 for BN254 G1 (Kp = 512) and G2 (Kp = 352) at 256 lanes, the shapes
   of the Groth16 prover; tree_sum (all three curves) and the BN254 horner at
   one block of the mesh-sharded Groth16 MSMs (128 lanes, 256 or 192 basis
   points; ed25519 at phase 7's range-basis MSM, 96 points); the probe
   kernels padd_chain and fe_mul, and pair_add at P5's shape; mont_padd,
   the five fold_ablate variants and padd_f32_chain at their probes'
   shapes (pair_add ed25519 at both shapes, padd_chain, fe_mul, mont_padd
   and padd_f32_chain also with the card's time a launch from the
   profiler; fe_mul also at ragged lane counts, from a base not 16-byte
   aligned and chained on its own output); mont_mul, limb for limb, at an NTT stage of a 256-statement h
   batch (twiddles broadcast), with a one-row operand, at MiMC's 4096 rows
   (b = a, and one row), at ragged last blocks, at b rows that are no
   contiguous run of a block, from bases not 16-byte aligned and at P6's
   2^20 rows, the timed ones also with the card's time a launch from the
   profiler; mont_mul_n11 (f128, 11 limbs), limb for limb, at the
   improvement batch's shapes (the forward NTT's last stage at N = 64 over
   256 traces, to_mont, the coset shift), at rows near p and its multiples
   with relaxed negative and unreduced limbs, at ragged and odd row counts
   and from bases one 44-byte row past an aligned one. The cooperative kernels (window_sum and horner ed25519,
   window_sum4 G1 and G2, tree_sum on every curve, horner G1 and G2,
   horner4 G1 and G2, pair_add G1 and G2) are held limb for limb, also at
   ragged shapes (window_sum: Kp in {1, 2, 3,
   33, 160}, B in {1, 7, 513}, Kp in {8, 32, 64, 96}, B in {1, 7, 512},
   and at 512 lanes with its warps a block
   compared (1, 2, 4, the geometry's choice and every level-1 padd at once,
   also at 1024); horner
   ed25519: B in {1, 7, 8, 9, 1023}, B = 1 timed as 9 chained steps;
   window_sum4 G2: B in {1, 3}, Kp in {32, 33}; window_sum4 G1: B in {1,
   3}, Kp in {1, 8, 32, 33} at every node count G, also against its order
   model, at Kp 512 and 352 (1024 lanes) at the rule's G, its neighbours
   and G = Kp, timed in turns (the ws4_g1_groups line), and at Kp = 8, 128
   lanes, timed; tree_sum ed25519: B in {1, 127}, k in {1, 2, 3, 95}, and
   k = 40, 20 at 128 lanes; tree_sum G2:
   B in {1, 127}, k in {1, 2, 3, 191}, and k = 96, 64 at 128 lanes;
   tree_sum G1: B in {1, 127}, k in {1, 2, 3, 255}, and k = 192, 128, 96, 64
   at 128 lanes; horner G1 and G2: B in {1, 5, 6, 127, 129}, B = 1 timed as
   9 chained padds; horner4 G1 and G2: B in {1, 5, 6, 257}, B = 1 timed as
   36 chained padds; pair_add G2: K in {1, 5, 6, 128, 353}, K = 1 timed;
   pair_add G1: K in {1, 5, 6, 8, 128, 512}, K = 8 and 512 timed;
   pair_add ed25519: K in {1, 7, 8, 9, 161}); mont_mul also at the
   membership h's NTT stage (n = 1024, 256 statements), timed;
3g. blake3, word for word against ``compress_vec``, at the improvement
   batch's 2^14 leaves of 16 bytes (the kernels line) and a 2^13-lane
   level of 64-byte blocks, both timed, and at ragged lane counts, message
   lengths and flags;
3f. pair_add, window_sum4 and horner4 for BN254 G1 and G2 at the
   membership path's shapes, limb for limb against their plain versions and
   timed: window_sum4 G1 at Kp 608, 1024, 480 and G2 at Kp 608 over 256
   lanes, horner4 on their sums, pair_add at each Kp;
4. (phases 4 to 6b run with the seam pinned to the single-device route, a
   one-position mesh, on any number of cards) the main path: ``prove_range_batch`` of 256 range proofs (512 prover
   lanes; T1/T2 and the L/R MSMs at 1024 lanes) with the launch counters
   zeroed just before and read just after, then warm batches timed, one
   under ``torch.profiler`` for the card's busy time and K1's and K2's
   shares, a sample of proofs verified by the port's host verifier, and 4
   lanes held byte for byte against the port's host prover under injected
   randomness;
5. the Groth16 path: setup, then ``prove_equality_batch`` of 256 distinct
   equality statements with the launch counters zeroed just before and read
   just after (h: 43 mont_mul launches; the five query MSMs: 40 window_sum4
   and 40 horner4 launches, and the five table builds), then warm batches:
   three timed, one split into h (host sparse products, device NTTs), device
   query MSMs and host finish, one under ``torch.profiler``
   for the device's busy time; 8 sampled proofs verified by the port's host
   verifier, a tampered one rejected, and 2 lanes held byte for byte against
   the port's host golden prover under injected randomness;
6. the Groth16 grouped route: ``prove_equality_batch`` of 256 proofs of 8
   statements (32 each), every statement through ``_finish_proof_group``,
   with the launch counters zeroed just before and read just after; then
   the per-proof and grouped routes interleaved on the same batch and the
   same injected draws, timed, every run's bytes equal; one grouped run
   under ``torch.profiler`` (the card's time in pair_add G1 and window_sum4
   G1, the table builds' wall time); 2 lanes held byte for byte against the
   host golden prover (phases 5 and 6 finish each proof and run the sparse
   products on the native tier);
6b. the membership path: setup, then ``prove_membership_batch`` of 256
   distinct statements (sets of 1 to 64 values) with the launch counters
   zeroed just before and read just after (the five query tables' builds:
   4 x 255 pair_add G1 and 255 G2; 8 window_sum4 and 8 horner4 launches a
   query MSM; the h at n = 1024, 46 mont_mul launches), warm batches timed,
   one split into h, device query MSMs and host finish, a seeded batch
   profiled, 4 lanes held byte for byte against the native baseline
   ``prove_assigned_native`` and the host golden prover, every proof
   checked by ``verify_membership_batch`` and a forged one singled out; the
   seam's table LRU is restored after it;
6c. the improvement path (STARK, scheme 5): ``prove_improvement_batch`` of
   256 distinct (old, new) pairs on the card route with the launch
   counters zeroed just before and read just after (16 mont_mul_n11
   launches: the coset LDE of every trace; one blake3: every leaf), warm batches timed in turns
   with the native whole-pipeline baseline on the same pairs, every proof
   byte-identical, one batch split into upload, device LDE + commit,
   download and host assembly, one profiled (idle share), the device
   program's parts timed alone, 16 pairs on the CPU's plain route
   byte-identical, every proof verified by the native verifier and the
   Python one (ms a proof), a tampered one rejected, and the native NTT and
   BLAKE3 hooks timed against their goldens;
6e. the device BLAKE3 tier (``device_hash``) at 2^14 rows of 16 bytes:
   ``hash_leaves_device`` (one blake3 launch), ``merkle_tree_device`` (1 +
   14) and ``hash_element_rows(..., device=)`` (one), launches asserted,
   every digest equal to the native tier's, timed in turns with it, one
   call of each profiled;
6f. the device Ristretto decode and encode (``ristretto_device``): every
   compressed point of phase 4's envelopes and crafted rejections through
   ``ristretto_decompress_device``, lane for lane against the native
   ``decompress`` (``None`` included), the decoded points re-encoded by
   ``ristretto_compress_device`` against the inputs and the native
   ``compress``, both timed in turns with the native loops and profiled;
6d. the reference API's batch path (``api_batch``): 384 ops, 64 of each
   kind interleaved, through ``create_proof_batch``, the ``batch_add_*``
   calls and ``process_batch`` on the card (the MiMC pre-hash of 128
   values, the equality and membership buckets, one Bulletproofs pool of
   448 instances, the improvements), cold with the launch counters zeroed
   just before and read just after and the seam tables it touches counted
   against the LRU's 16, then warm in turns with the six per-kind batch
   entry points (the first warm batch asserted to build no table), each
   batch split by bucket, one profiled (idle share); every proof verified
   by ``verify_proofs_parallel`` and its own ``verify_*`` (timed in turns),
   a flipped byte in one proof of each kind rejected, a composite of six
   verified; the pre-hash against per-value ``commit_value_snark`` at 128
   and 384 values. The seam's table LRU is restored after it;
7. the mesh-sharded MSM on a (dp 2, shard 2) mesh whose four positions are
   all this card (it checks the sharding, the per-block kernels and the
   cross-shard fold, and measures no interconnect): the five query MSMs of a
   256-statement batch and one ed25519 MSM through ``msm_many_sharded``,
   launch counts checked, every point equal to the single-device route's;
8. ``prove_equality_batch`` of phase 5's statements with the seam on that
   mesh (``set_mesh``), cold and warm, every envelope equal to phase 5's
   under the same injected draws; phases 7 and 8 run again on a mesh of the
   real devices when more than one card is visible;
9. the h crossover: ``h_batch_device`` against the host NTTs for 1, 16, 64,
   170 and 256 distinct statements, every h equal;
10. ``mimc_hash_batch`` of 4096 values, cold (332 mont_mul launches) and
    warm, every digest equal to the host's, and again on a one-card dp 2
    mesh; one warm batch under ``torch.profiler`` (mont_mul's card time a
    launch);
10b. the multi-device layer (``multi_device``) on a (dp 2, shard 2) mesh
    whose four positions are all this card (no interconnect measured):
    ``psum``, ``all_gather`` (stacked and tiled), ``all_to_all`` and
    ``ppermute`` over both axes against their plain results, and
    ``axis_index`` and ``axis_size``; ``ntt_sharded`` at N = 2^18 on BN254
    Fr (``mont_mul``) and f128 (``mont_mul_n11``), shard 2 and 4, forward
    and inverse, with its launches asserted, every value equal to the
    one-device ``ntt_device``'s (and BN254 Fr's forward to the native
    ``ntt`` hook), timed in turns with it; ``coset_lde_batch`` of 256 traces
    of 8 at blowup 8 split over dp 1, 2 and 4 (16 ``mont_mul_n11`` launches
    a block), equal; ``dryrun_multichip(4)`` and ``(8)``; and
    ``init_distributed`` in subprocesses over NCCL with a ``file://``
    rendezvous (world 1 on this card; world 2, a card each, where two are
    visible): one ``all_reduce`` and the port's ``psum``, ``all_gather``,
    ``all_to_all`` and ``ppermute`` over the dp axis that spans them;
11. the probes (``libzkp_tpu_torch.probes``: P2, P4, P5, P6, P7, P1, P3);
12. the native host tier (``native``) on this machine's host: Keccak,
    ``compress``, ``decompress`` (64 invalid encodings among 256),
    ``scalar_mul``, ``msm`` (n = 1, 2, 7, 33, 130) and ``msm_fixed`` held
    equal to their ``*_py`` goldens on seeded inputs, µs a call both ways,
    the OpenMP team, and the fixed MSM at several teams and window chunks
    (``native_hooks``); the whole-pipeline native prover
    ``_prove_batch_native`` beside the card's route on the same instances
    and draws, in turns, every proof byte-identical: 64 bits on the main
    path's 256 proofs, 8, 16 and 32 bits on bp_rest's (``native_baseline``);
    ``batch_verify_groups`` (native) against ``batch_verify_groups_py`` on
    the main path's envelopes, ms a proof, a tampered proof rejected by both
    (``native_verifier``); the BN254 and Groth16 hooks held equal to their
    goldens (G1 and G2 ``scalar_mul``, ``msm`` at n = 1, 2, 7, 33, 130,
    ``msm_fixed`` at one point and 589, ``multi_pairing`` at 4 and 35 pairs,
    the sparse products and h of both circuits), µs a call both ways, the
    one-point calls' teams, multi-pairings serial and on the team
    (``native_groth16_hooks``); ``prove_assigned_native`` beside the card
    route on phase 5's and 6b's statements, in turns, byte-identical
    (``native_groth16_baseline``); ``verify`` against ``verify_py``, in
    turns with the G2 subgroup check the JAX package makes (reduced mod R),
    the check alone, and ``verify_batch`` a proof (``native_groth16_verify``). The seam's table
    LRU is restored after it, so bp_rest's cold tables stay cold;
13. the rest of the Bulletproofs backend (``bp_rest``): 256 threshold
    proofs (``prove_threshold_batch``), 64 consistency proofs of 5 values
    (``prove_consistency_batch``) and 256 range proofs at each of 8, 16 and
    32 bits on the lockstep host prover (its MSMs through the ed25519 seam,
    K1 at Kp 8, 32, 64, 96), each batch cold with its launches asserted,
    warm batches timed, a seeded batch profiled (busy ms, idle share, K1's
    and K2's device ms, the host's parts) with 4 lanes held byte for byte
    against the host prover (timed: the host figure), 8 proofs verified and
    a tampered one rejected; the host parts and the host ``prove_single`` run
    on the native hooks;
14. the kernels line (launches summed over the paths), the card's name and
    power limit, and the last line ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line. Without a CUDA
device it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import functools
import json
import random
import subprocess
import sys
import time
from collections import defaultdict

import torch

N_TRIPLES = 256       # range proofs per batch: 512 prover lanes
# bp_rest's batches: threshold proofs (one 64-bit instance each), consistency
# proofs of BP_REST_VALUES values (BP_REST_VALUES - 1 instances each), and
# N_TRIPLES range proofs at each width on the lockstep host prover
BP_REST_THRESHOLDS = 256
BP_REST_SEQUENCES, BP_REST_VALUES = 64, 5
BP_REST_WIDTHS = (8, 16, 32)
BP_REST_KPS = (8, 32, 64, 96)  # the seam's padded bases there: [B, B_blinding]; A/S and L/R at 8, 16, 32 bits
BP_REST_LANES = 4     # lanes of each batch held byte for byte against the host prover
WIDTH_TIMED_BATCHES = 2  # the widths batches' warm repeats, cut from TIMED_BATCHES for the run's time
KP = 160              # padded basis of [B_blinding] + G(64) + H(64) + [B]
MSM_LANES = 1024      # T1||T2 and L||R MSMs run at twice the prover lanes
TIMED_BATCHES = 3
HOST_MEM_BW = 3.35e12  # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
INT32_LANES_PER_SM = 64  # IMAD results per clock per SM, compute capability 9.0
FP32_LANES_PER_SM = 128  # FFMA results per clock per SM, compute capability 9.0
MUL_MACS = 24 * 24 + 26 * 24  # one field product: 576 conv + 624 fold multiply-adds
# p = 2^255 - 19: 576 conv + the 52 fold multiply-adds whose constant is not 0
ED_MUL_MACS = 24 * 24 + 52
BN_MUL_MACS = 24 * 24 + 564  # BN254 Fq, likewise: 564 nonzero fold constants
MONT_MACS = 2 * 22 * 22 + 22  # one Montgomery product: 484 conv + 484 REDC + 22 m
# P3's float32 product: 841 conv FMAs + the 62 fold FMAs whose constant is not 0
F32_MUL_FMAS = 29 * 29 + 62
H_N = 512              # the equality circuit's domain
H_BATCHES = (1, 16, 64, 170, 256)  # distinct statements per h batch (groth16_h)
H_MONT_MULS = 43       # mont_mul launches of one h_batch_device call at n = 512
MIMC_VALUES = 4096     # values per MiMC batch (bench.py's size)
MIMC_MONT_MULS = 332   # to_mont, 110 rounds x 3, from_mont
# mont_mul's cases timed in phase 3e (tags of _mont_cases; None: the NTT stage)
MONT_TIMED = (None, "membership NTT stage", "one-row operand", "MiMC x * x", "MiMC to_mont", "P6",
              "f128 LDE stage", "f128 to_mont")
# the improvement phase: distinct (old, new) pairs a batch, those proved on
# the CPU's plain route too, and the batch's mont_mul_n11 launches (to_mont,
# the inverse NTT's 3 stages and n^-1 with its to_mont, the coset shift, the
# forward NTT's 6 stages and one reduce, two from_mont)
IMP_PAIRS = 256
IMP_PLAIN_PAIRS = 16
IMP_MONT_MULS = 16
IMP_TRACE, IMP_BLOWUP = 8, 8  # the improvement AIR's trace length and blowup: N = 64
# the api_batch phase: API_OPS ops through the reference API's batch
# registry, op i of kind API_KINDS[i % 6] (64 of each); API_PREHASH_VALUES
# the distinct value counts of the MiMC pre-hash comparison (the batch's 128
# equality and membership values, and 256 more)
API_KINDS = ("range", "equality", "threshold", "membership", "improvement", "consistency")
API_OPS = 384
API_PREHASH_VALUES = (128, 384)
PADD_MACS = 9 * ED_MUL_MACS   # Edwards padd: 9 products
PDOUBLE_MACS = 8 * ED_MUL_MACS
WPADD_MACS = {"bn254_g1": 12 * MUL_MACS + 2 * 24,  # RCB padd: 12 products + 2 small multiplies
              "bn254_g2": 42 * MUL_MACS}           # 14 Fq2 products of 3
BN_KP = {"bn254_g1": 512, "bn254_g2": 352}  # h query (511 points), b_g2 query (334)
G1_KPS = (512, 352)    # window_sum4 G1's Kp in a Groth16 batch: the h query, the a, b_g1, l queries
G16_LANES = 256        # distinct equality statements per batch
G16_VERIFY = 8
G16_GROUP_STATEMENTS = 8  # statements of the grouped batch: 32 proofs each
MEM_LANES = 256        # distinct set-membership statements per batch
MEM_BYTE_LANES = 4     # lanes of the seeded membership batch held byte for byte
# the membership circuit's query tables: a, b_g1, b_g2 (589 points: Kp 608),
# h (1023: Kp 1024), l (459: Kp 480); its h runs at n = 1024
MEM_G1_KPS = (608, 1024, 480)
MEM_G2_KP = 608
MEM_H_N = 1024
MEM_H_MONT_MULS = 46   # mont_mul launches of one h_batch_device call at n = 1024 (a stage more a transform)
NATIVE_VERIFY = 8      # proofs of each scheme verified by verify and verify_py (native_groth16)
PAIRING_SWEEP = (4, 8, 16, 35, 259)  # multi-pairing sizes timed serial and on the team (native_groth16)
NATIVE_H_WORKERS = (1, 2, 4, 8)  # prove_assigned_native's h pool sizes, timed in turns (native_groth16)
# the G1 kernels' names in a profile, this tree's and the one-thread kernels'
# they replaced (so the profiles of two checkouts compare)
WS4_G1_KERNELS = ("window_sum4_g1_nodes_kernel", "window_sum4_g1_top_kernel", "window_sum4_kernel<Bn254G1>")
PAIR_ADD_G1_KERNELS = ("coop_horner_kernel<G1Coop, 1, 0>", "pair_add_kernel<Bn254G1>")
# tree_sum's kernels in a profile (ed25519: this tree's and the one-warp
# kernel it replaced), and in the ptxas log (mangled)
TREE_SUM_KERNELS = {"ed25519": ("tree_sum_coop_kernel<EdCoop>", "tree_sum_kernel<Ed25519>"),
                    "bn254_g1": ("tree_sum_coop_kernel<G1Coop>",), "bn254_g2": ("tree_sum_coop_kernel<G2Coop>",)}
PTXAS_KERNELS = {"mont_mul": ("mont", "mont_mul_kernel"),
                 "tree_sum_ed25519": ("tree_sum", "tree_sum_coop_kernelI6EdCoop", "tree_sum_kernelI7Ed25519"),
                 "pair_add_ed25519": ("pair_add", "coop_horner_kernelI6EdCoopLi1ELi0E", "pair_add_kernelI7Ed25519"),
                 "padd_f32_chain": ("probes", "padd_f32_coop_kernel", "padd_f32_chain_kernel"),
                 "padd_chain": ("probes", "coop_chain_kernelI6EdCoop", "padd_chain_kernel", "_Z6fe_mul"),
                 "mont_padd": ("probes", "mont_padd_kernel", "mont_mul22"),
                 "fe_mul": ("probes", "fe_mul_kernel"),
                 "blake3": ("blake3", "blake3_kernel")}
# K3 pair_add ed25519's and P3's kernels in a profile: this tree's and the
# one-thread kernels they replaced
PAIR_ADD_ED_KERNELS = ("coop_horner_kernel<EdCoop, 1, 0>", "pair_add_kernel<Ed25519>")
F32_CHAIN_KERNELS = ("padd_f32_coop_kernel", "padd_f32_chain_kernel")
# P2's and P7's kernels in a profile: this tree's and the one-thread P2
# kernel it replaced (P7's kept its name)
CHAIN_KERNELS = ("coop_chain_kernel<EdCoop>", "padd_chain_kernel")
MONT_PADD_KERNELS = ("mont_padd_kernel",)
# P4's kernels in a profile: this tree's (one a product) and the kernel with
# the out-of-line product they replaced
FE_MUL_KERNELS = ("fe_mul_kernel",)
# BN254 Fq's product with its constants in the code and on the consts block
# in __constant__, timed in turns (fe_mul)
FE_MUL_ABLATION = ("immediates", "c_consts", "c_consts", "immediates", "immediates", "c_consts")
FE_MUL_RAGGED = (1, 7, 100, 1000, (1 << 20) - 3)  # lanes of the ragged checks
ED_CHAIN_WARPS = (1, 2, 4, 8, 8, 4, 2, 1)  # warps a block, timed in turns (ed_chain)
MONT_PADD_SWEEP = (64, 128, 256, 256, 128, 64)  # lanes a block, timed in turns (mont_padd)
ED_PAIR_WARPS = (1, 4, 8, 8, 4, 1)  # warps a block, timed in turns (ed_pair)
CURVE_PADD_MACS = {"ed25519": PADD_MACS, **WPADD_MACS}
SHARD_DP, SHARD_SHARD = 2, 2  # the one-card mesh: four positions, all cuda:0
SHARD_B_LOCAL = G16_LANES // SHARD_DP
# basis points per block of phase 7's MSMs (shard 2): the range basis (Kp 160),
# the h query (Kp 512), the b_g2 query (Kp 352)
SHARD_K_LOCAL = {"ed25519": 96, "bn254_g1": 256, "bn254_g2": 192}
# the multi_device phase: its (dp, shard) mesh of this card; the four-step
# NTT's size (the JAX package's suggested gate) and shard counts; the LDE's
# dp splits; the dry runs' position counts; each init_distributed worker's
# time limit in seconds
MD_DP, MD_SHARD = 2, 2
MD_NTT_N = 1 << 18
MD_NTT_SHARDS = (2, 4)
MD_LDE_DPS = (1, 2, 4)
MD_DRYRUNS = (4, 8)
MD_DIST_TIMEOUT = 180
# the blake3 kernel and the device BLAKE3 tier: the improvement batch's
# leaves (IMP_PAIRS traces of IMP_TRACE * IMP_BLOWUP rows of 16 bytes), a
# tree over as many rows, and the kernel's bound: 7 rounds of 8 G steps of
# 14 add, xor and rotate operations and 8 output xors a compression, 16
# int64 words read and 8 written a lane
B3_ROWS, B3_ROW_BYTES = IMP_PAIRS * IMP_TRACE * IMP_BLOWUP, 16
B3_OPS = 7 * 8 * 14 + 8
B3_LANE_BYTES = (16 + 8) * 8
B3_RAGGED = ((1, 0, 11), (255, 33, 11), (257, 64, 0), (1000, 7, 0xFF))  # (lanes, block_len, flags)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(macs: float, nbytes: float, int_rate: float):
    """The larger of ``macs`` operations at ``int_rate`` per second (or an
    FP32 rate) and ``nbytes`` at the card's memory rate, in ms."""
    t_ops = macs / int_rate * 1e3
    t_bytes = nbytes / HOST_MEM_BW * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def profiled(run) -> tuple:
    """``run()`` under ``torch.profiler`` (CUDA activity): its result, its
    wall ms (host clock around the call and a synchronise) and the card's
    busy entries, (name, device us, calls) for each kernel and copy, summed
    from the raw trace events (``key_averages()`` builds an event tree in
    Python: about 45 s for a range batch's 230,000 device operations)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    busy = defaultdict(lambda: [0.0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            entry = busy[e.name()]
            entry[0] += e.duration_ns() / 1e3
            entry[1] += 1
    return out, ms, [(name, us, calls) for name, (us, calls) in busy.items()]


def busy_summary(busy: list, wall_ms: float, **kernels) -> dict:
    """The card's busy ms, idle share and operations over ``wall_ms``, the
    8 busiest entries, and for each keyword the device ms and calls of the
    entries whose name holds its value (or one of a tuple of values: a
    kernel's names before and after a redesign)."""
    busy_ms = sum(b[1] for b in busy) / 1e3
    out = {"device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
           "device_ops": sum(b[2] for b in busy),
           "top": [{"name": b[0][:60], "device_ms": b[1] / 1e3, "calls": b[2]}
                   for b in sorted(busy, key=lambda b: -b[1])[:8]]}
    for key, sub in kernels.items():
        subs = sub if isinstance(sub, tuple) else (sub,)
        hits = [b for b in busy if any(x in b[0] for x in subs)]
        calls = sum(b[2] for b in hits)
        out[key] = {"device_ms": sum(b[1] for b in hits) / 1e3, "calls": calls,
                    "device_us_per_call": sum(b[1] for b in hits) / calls if calls else None}
    return out


def card_time(run, names: tuple, iters: int) -> dict:
    """The card's time in the kernels whose names hold one of ``names``
    over ``iters`` calls of ``run()`` under ``torch.profiler``, after one
    warm-up call: µs a launch, and µs of device-to-device copies a launch
    (a consts block copied into constant memory before the kernel). A
    profile of a few short launches can come back without their kernel
    records (seen on the H100), so it is taken up to three times; raises if
    none holds a launch."""
    run()
    torch.cuda.synchronize()
    for _ in range(3):
        _, _, busy = profiled(lambda: [run() for _ in range(iters)])
        hits = [b for b in busy if any(x in b[0] for x in names)]
        calls = sum(b[2] for b in hits)
        if calls:
            dtod = sum(b[1] for b in busy if "Memcpy DtoD" in b[0])
            return {"kernel_us": sum(b[1] for b in hits) / calls, "launches": calls, "dtod_us": dtod / calls}
    raise AssertionError(f"no launch of {names} in three profiles")


def ptxas_summary(log: str, names: tuple) -> dict:
    """Registers, stack frame and spill bytes of the entry functions in an
    ``nvcc -Xptxas -v`` log whose mangled names hold one of ``names``."""
    import re

    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", ln)
        if m:
            cur = m.group(1) if any(x in m.group(1) for x in names) else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out.setdefault(cur, {}).update(zip(("frame", "spill_stores", "spill_loads"), map(int, m.groups())))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return out


def _edwards_point_err(a, b) -> int:
    """Largest residue mod p of the projective cross-products
    X1*Z2 - X2*Z1, Y1*Z2 - Y2*Z1, T1*Z2 - T2*Z1 between the lanes of ``a``
    and ``b`` (each (C, n, B) ed25519 limbs) and of the extended-coordinate
    invariant T*Z - X*Y within each lane: 0 when every lane of ``a`` is the
    same valid point as in ``b``. A lane with Z = 0 mod p on either side
    (a lane left unwritten, say, which passes every cross-product) is no
    point and gives p."""
    import numpy as np

    from libzkp_tpu_torch.ops import curve, ed25519 as ed

    eng = curve.edwards_engine()
    P = ed.P

    def pts(t):
        return eng.decode_points(np.transpose(t.cpu().numpy(), (2, 0, 1)))

    err = 0
    for (X1, Y1, Z1, T1), (X2, Y2, Z2, T2) in zip(pts(a), pts(b), strict=True):
        if Z1 % P == 0 or Z2 % P == 0:
            return P
        err = max(err, (X1 * Z2 - X2 * Z1) % P, (Y1 * Z2 - Y2 * Z1) % P,
                  (T1 * Z2 - T2 * Z1) % P, (T1 * Z1 - X1 * Y1) % P, (T2 * Z2 - X2 * Y2) % P)
    return err


def k1_warps(dev, consts, table, digits, want) -> None:
    """K1 at its path's shape with 1, 2 and 4 warps a block, with the
    geometry's choice and with every level-1 padd at once (the geometry's
    choice for one lane), each held limb for limb against ``want`` (the
    plain version's output), timed in turns; one k1_warps line."""
    from libzkp_tpu_torch.ops import kernels

    Kp, B = digits.shape
    curve = "ed25519"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rule = kernels.coop_sum_geometry(curve, Kp, B, sms)[0]
    full = kernels.coop_sum_geometry(curve, Kp, 1, sms)[0]
    per_warp = kernels.COOP_PADDS_PER_WARP[curve] * kernels.COOP_SCRATCH_BYTES[curve]
    out = torch.empty_like(want)

    def run(warps):
        smem = (Kp + 1) // 2 * kernels.POINT_BYTES[curve] + warps * per_warp
        kernels._run("window_sum", curve, dev, consts.data_ptr(), table.data_ptr(), digits.data_ptr(),
                     out.data_ptr(), Kp, B, warps, smem)

    ms = {}
    order = sorted({1, 2, 4, rule, full})
    for warps in order + order[::-1]:
        run(warps)
        torch.cuda.synchronize()
        _limbs_err(f"window_sum at {warps} warps a block", out, want)
        ms.setdefault(warps, []).append(cuda_ms(lambda: run(warps), 20))
    emit({"phase": "k1_warps", "shape": f"digits ({Kp},{B})", "rule_warps": rule, "full_warps": full,
          "ms": {w: sum(t) / len(t) for w, t in ms.items()}, "ms_runs": ms})


def ragged_window_sum(dev, consts, table) -> None:
    """K1 at ragged shapes, B in {1, 7, 513} lanes over the first Kp in
    {1, 2, 3, 33, 160} basis points of the path's table (a lone point, the
    tree's odd carries, one lane past V, A and S's 512), and B in {1, 7,
    512} over the first Kp in BP_REST_KPS (the seam's bases on the widths
    path, 512 lanes a chunk), limb for limb against the plain version; one
    kernel_check line each (not in the kernels line)."""
    from libzkp_tpu_torch.ops import kernels

    C, n = table.shape[1:]
    shapes = [(Kp, (1, 7, 513)) for Kp in (1, 2, 3, 33, KP)] + [(Kp, (1, 7, 512)) for Kp in BP_REST_KPS]
    for Kp, lane_counts in shapes:
        sub = table[:Kp * 256]
        for B in lane_counts:
            digits = torch.randint(0, 256, (Kp, B), dtype=torch.int32,
                                   generator=torch.Generator().manual_seed(10 * Kp + B)).to(dev)
            got = kernels.window_sum(consts, sub, digits)
            want = kernels.window_sum_plain(consts, sub, digits)
            torch.cuda.synchronize()
            err = _limbs_err(f"window_sum at Kp {Kp}, B {B}", got, want)
            emit({"phase": "kernel_check", "name": "window_sum", "ragged": True,
                  "max_abs_err": float(err), "tolerance": "exact limbs",
                  "shape": f"table ({Kp * 256},{C},{n}) i16, digits ({Kp},{B}) i32"})


def check_kernels(dev, int_rate: float, tables: dict) -> list:
    """Phase 3: each kernel against its plain version at the path's shapes,
    limb for limb: window_sum (K1) also at 512 lanes, at its warps a block
    compared (:func:`k1_warps`) and at ragged shapes
    (:func:`ragged_window_sum`), horner (K2) and pair_add (K3) also at
    ragged lane counts (:func:`ragged_horner`, :func:`ragged_pair_add`). Leaves the table in ``tables["ed25519"]``."""
    from libzkp_tpu_torch.ops import curve, kernels

    eng = curve.edwards_engine()
    C, n = eng.coords, eng.n
    consts, table = ed_table(dev)
    digits = torch.randint(0, 256, (KP, MSM_LANES), generator=torch.Generator().manual_seed(7),
                           dtype=torch.int32).to(dev)
    tables["ed25519"] = (consts, table, KP)

    results = []
    # K1 at the T1||T2 and L||R MSMs' 1024 lanes (the kernels line) and at
    # V, A and S's 512 (a kernel_check line)
    for lanes in (MSM_LANES, MSM_LANES // 2):
        d = digits[:, :lanes].contiguous()
        ws_k = kernels.window_sum(consts, table, d)
        ws_p = kernels.window_sum_plain(consts, table, d)
        torch.cuda.synchronize()
        err = _limbs_err(f"window_sum at {lanes} lanes", ws_k, ws_p)
        t_k = cuda_ms(lambda: kernels.window_sum(consts, table, d), 20)
        t_p = cuda_ms(lambda: kernels.window_sum_plain(consts, table, d), 3)
        b_ms, b_by = bound((KP - 1) * PADD_MACS * lanes,
                           table.numel() * 2 + d.numel() * 4 + C * n * lanes * 4, int_rate)
        row = dict(name="window_sum", route="cuda", source="libzkp_tpu_torch/csrc/window_sum.cu",
                   replaces="libzkp_tpu/ops/curve_jax.py:626", max_abs_err=float(err),
                   tolerance="exact limbs", ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None, shape=f"table ({KP * 256},{C},{n}) i16, digits ({KP},{lanes}) i32")
        if lanes == MSM_LANES:
            results.append(row)
        else:
            emit({"phase": "kernel_check", **row})
        k1_warps(dev, consts, table, d, ws_p)
    ragged_window_sum(dev, consts, table)

    ws_k = kernels.window_sum(consts, table, digits)
    acc_in, wsum = ws_k, kernels.window_sum_plain(consts, table, digits)
    h_k = kernels.horner(consts, acc_in, wsum)
    h_p = kernels.horner_plain(consts, acc_in, wsum)
    torch.cuda.synchronize()
    err = _limbs_err("horner", h_k, h_p)
    ragged_horner(dev, "ed25519", consts, wsum, (1, 7, 8, 9, MSM_LANES - 1))
    t_k = cuda_ms(lambda: kernels.horner(consts, acc_in, wsum), 50)
    t_p = cuda_ms(lambda: kernels.horner_plain(consts, acc_in, wsum), 5)
    b_ms, b_by = bound((8 * PDOUBLE_MACS + PADD_MACS) * MSM_LANES, 3 * C * n * MSM_LANES * 4, int_rate)
    results.append(dict(name="horner", route="cuda", source="libzkp_tpu_torch/csrc/horner.cu",
                        replaces="libzkp_tpu/ops/curve_jax.py:431",
                        max_abs_err=float(err), tolerance="exact limbs",
                        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        shape=f"acc, wsum ({C},{n},{MSM_LANES}) i32"))

    p = table.view(KP, 256, C, n)[:, 7].permute(1, 2, 0).to(torch.int32).contiguous()
    q = table.view(KP, 256, C, n)[:, 200].permute(1, 2, 0).to(torch.int32).contiguous()
    a_k = kernels.pair_add(consts, p, q)
    a_p = kernels.pair_add_plain(consts, p, q)
    torch.cuda.synchronize()
    err = int((a_k - a_p).abs().max())
    if err != 0:
        raise AssertionError(f"pair_add limbs differ from its plain version (max {err})")
    t_k = cuda_ms(lambda: kernels.pair_add(consts, p, q), 200)
    t_p = cuda_ms(lambda: kernels.pair_add_plain(consts, p, q), 20)
    b_ms, b_by = bound(PADD_MACS * KP, 3 * C * n * KP * 4, int_rate)
    results.append(dict(name="pair_add", route="cuda", source="libzkp_tpu_torch/csrc/pair_add.cu",
                        replaces="libzkp_tpu/ops/curve_jax.py:482",
                        max_abs_err=float(err), tolerance="exact limbs",
                        ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                        shape=f"p, q ({C},{n},{KP}) i32",
                        card=card_time(lambda: kernels.pair_add(consts, p, q), PAIR_ADD_ED_KERNELS, 50)))
    ragged_pair_add(dev, "ed25519", consts, table, table.view(KP, 256, C, n)[:, 1].permute(1, 2, 0).to(torch.int32),
                    h_k)
    for r in results:
        emit({"phase": "kernel_check", **r})
    return results


def _random_points(curve: str, count: int, rng: random.Random) -> list:
    """``count`` random multiples of the generator (host Jacobian points)."""
    from libzkp_tpu_torch.models import groth16

    g1b, g2b = groth16._bases()
    base = g1b if curve == "bn254_g1" else g2b
    return [base.mul(rng.randrange(1, groth16.R)) for _ in range(count)]


def _weierstrass_point_err(curve: str, a, b) -> int:
    """Largest residue mod p, over the lanes of ``a`` and ``b`` (each
    (C, n, L)), of the projective cross-products X1*Z2 - X2*Z1 and
    Y1*Z2 - Y2*Z1 (per Fq or Fq2 coordinate) and of the curve equation
    Y^2 Z - X^3 - b Z^3 of each lane: 0 when every lane of ``a`` is the same
    point of the curve as in ``b``. A lane that is (0 : 0 : 0) on either side
    (a lane left unwritten, say, which passes every cross-product and the
    curve equation) is no point and gives p."""
    import numpy as np

    from libzkp_tpu_torch.ops import bn254 as bn
    from libzkp_tpu_torch.ops.weierstrass import get_engine

    eng = get_engine(curve)
    P = bn.P

    def coords(t):
        vals = eng.ctx.decode(np.transpose(t.cpu().numpy(), (2, 0, 1)))
        r = eng.rows
        return [[tuple(vals[i + k * r : i + (k + 1) * r]) for k in range(3)]
                for i in range(0, len(vals), eng.coords)]

    if eng.rows == 1:
        mul = lambda x, y: ((x[0] * y[0]) % P,)  # noqa: E731
        sub = lambda x, y: ((x[0] - y[0]) % P,)  # noqa: E731
        bconst = (bn.B_G1,)
    else:
        mul, sub, bconst = bn.fq2_mul, bn.fq2_sub, bn.B_G2
    err = 0
    for (X1, Y1, Z1), (X2, Y2, Z2) in zip(coords(a), coords(b), strict=True):
        if not any(c % P for c in X1 + Y1 + Z1) or not any(c % P for c in X2 + Y2 + Z2):
            return P
        diffs = [sub(mul(X1, Z2), mul(X2, Z1)), sub(mul(Y1, Z2), mul(Y2, Z1))]
        for X, Y, Z in ((X1, Y1, Z1), (X2, Y2, Z2)):
            lhs = mul(mul(Y, Y), Z)
            rhs = mul(mul(X, X), X)
            zz = mul(mul(Z, Z), Z)
            diffs.append(sub(sub(lhs, rhs), mul(bconst, zz)))
        err = max(err, *(c for d in diffs for c in d))
    return err


def _limbs_err(what: str, got, want) -> int:
    """0 when ``got`` and ``want`` hold the same limbs; raises otherwise."""
    err = int((got - want).abs().max())
    if err != 0:
        raise AssertionError(f"{what} limbs differ from its plain version (max {err})")
    return err


def g2_ragged_window_sum4(dev, consts, table) -> None:
    """window_sum4 G2 at the ragged edges of its block's tree: B in {1, 3}
    lanes over a table of Kp in {32, 33} basis points (the first Kp points of
    the path's table), limb for limb and point for point against the plain
    version; one kernel_check line each (not in the kernels line)."""
    from libzkp_tpu_torch.ops import kernels

    curve = "bn254_g2"
    for Kp in (32, 33):
        sub = table[:Kp * 256]
        for B in (1, 3):
            digits = torch.randint(0, 256, (kernels.WIN_GROUP, Kp, B), dtype=torch.int32,
                                   generator=torch.Generator().manual_seed(10 * Kp + B)).to(dev)
            got = kernels.window_sum4(consts, sub, digits, curve=curve)
            want = kernels.window_sum4_plain(consts, sub, digits, curve=curve)
            torch.cuda.synchronize()
            err = _limbs_err(f"window_sum4 {curve} at Kp {Kp}, B {B}", got, want)
            if _weierstrass_point_err(curve, got, want) != 0:
                raise AssertionError(f"window_sum4 {curve} at Kp {Kp}, B {B} disagrees with its plain version")
            emit({"phase": "kernel_check", "name": kernels.instance("window_sum4", curve), "ragged": True,
                  "max_abs_err": float(err), "tolerance": "exact limbs and point equality",
                  "shape": f"table ({Kp * 256},6,24) i16, digits (4,{Kp},{B}) i32"})


def window_sum4_plain_chunked(consts, table, digits, curve: str):
    """``window_sum4_plain`` in chunks of 64 lanes: the plain tree's stacked
    products would take tens of GB at 4 * 256 lanes at once."""
    from libzkp_tpu_torch.ops import kernels
    from libzkp_tpu_torch.ops.weierstrass import get_engine

    eng = get_engine(curve)
    WG, _, B = digits.shape
    out = torch.empty((eng.coords, eng.n, WG * B), dtype=torch.int32, device=digits.device)
    ch = min(64, B)
    for b0 in range(0, B, ch):
        part = kernels.window_sum4_plain(consts, table, digits[:, :, b0:b0 + ch].contiguous(), curve=curve)
        for w in range(WG):
            out[..., w * B + b0:w * B + b0 + ch] = part[..., w * ch:(w + 1) * ch]
    return out


def ws4_g1_forced(dev, consts, table, digits, G: int, out) -> None:
    """window_sum4 G1's launch with G nodes a lane (the wrapper's, with
    ``window_sum4_g1_geometry(groups=G)``) into ``out``."""
    from libzkp_tpu_torch.ops import kernels

    WG, Kp, B = digits.shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G, nodes_smem, warps, smem = kernels.window_sum4_g1_geometry(Kp, WG * B, sms, groups=G)
    nodes = torch.empty((WG * B * G, 3, 24), dtype=torch.int16, device=dev) if G < Kp else None
    kernels._run("window_sum4", "bn254_g1", dev, consts.data_ptr(), table.data_ptr(), digits.data_ptr(),
                 nodes.data_ptr() if nodes is not None else None, out.data_ptr(), Kp, B, G, nodes_smem,
                 warps, smem)


def _node_counts(Kp: int) -> list:
    """Every G window_sum4 G1 may split Kp into: Kp, Kp / 2, ... down to
    its odd part."""
    out = [Kp]
    while out[-1] % 2 == 0:
        out.append(out[-1] // 2)
    return out


def g1_ragged_window_sum4(dev, consts, table) -> None:
    """window_sum4 G1 at ragged shapes, B in {1, 3} lanes over the first Kp
    in {1, 8, 32, 33} basis points of the path's table: through the wrapper
    and with every G forced (kernel 1's chains of 2^l points, kernel 2's
    tree over G nodes), limb for limb against the order model
    (``window_sum4_order``) and the plain version; one kernel_check line
    each (not in the kernels line)."""
    from libzkp_tpu_torch.ops import kernels

    curve = "bn254_g1"
    for Kp in (1, 8, 32, 33):
        sub = table[:Kp * 256]
        for B in (1, 3):
            digits = torch.randint(0, 256, (kernels.WIN_GROUP, Kp, B), dtype=torch.int32,
                                   generator=torch.Generator().manual_seed(20 * Kp + B)).to(dev)
            want = kernels.window_sum4_plain(consts, sub, digits, curve=curve)
            got = kernels.window_sum4(consts, sub, digits, curve=curve)
            torch.cuda.synchronize()
            err = _limbs_err(f"window_sum4 {curve} at Kp {Kp}, B {B}", got, want)
            for G in _node_counts(Kp):
                model = kernels.window_sum4_order(consts, sub, digits, groups=G)
                ws4_g1_forced(dev, consts, sub, digits, G, got)
                torch.cuda.synchronize()
                _limbs_err(f"window_sum4 {curve}'s order model at Kp {Kp}, B {B}, G {G}", model, want)
                err = max(err, _limbs_err(f"window_sum4 {curve} at Kp {Kp}, B {B}, G {G}", got, model))
            emit({"phase": "kernel_check", "name": kernels.instance("window_sum4", curve), "ragged": True,
                  "max_abs_err": float(err), "tolerance": "exact limbs (order model and plain version)",
                  "groups": _node_counts(Kp),
                  "shape": f"table ({Kp * 256},3,24) i16, digits (4,{Kp},{B}) i32"})


def ws4_g1_groups(dev, consts, table, digits, want: dict) -> dict:
    """window_sum4 G1 at the Groth16 batch's shapes, over the first Kp in
    G1_KPS points of ``table`` and ``digits`` (the plain version's output
    in ``want[Kp]``), 1024 lanes, with G nodes a lane: the rule's choice,
    its neighbours and G = Kp (kernel 2 alone: the plain tree in one block a
    lane, coop_tree_sum over the digit gather), each held limb for limb,
    timed in turns; one ws4_g1_groups line. Returns {Kp: {G: ms}}."""
    from libzkp_tpu_torch.ops import kernels

    WG, _, B = digits.shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res, rules = {}, {}
    for Kp in G1_KPS:
        sub, d, ref = table[:Kp * 256], digits[:, :Kp].contiguous(), want[Kp]
        out = torch.empty_like(ref)
        rule = kernels.window_sum4_g1_geometry(Kp, WG * B, sms)[0]
        rules[Kp] = rule
        cands = _node_counts(Kp)
        i = cands.index(rule)
        order = sorted({Kp, *cands[max(0, i - 2):i + 3]})
        ms: dict = {}
        for G in order + order[::-1]:
            ws4_g1_forced(dev, consts, sub, d, G, out)
            torch.cuda.synchronize()
            _limbs_err(f"window_sum4 bn254_g1 at Kp {Kp}, G {G}", out, ref)
            ms.setdefault(G, []).append(cuda_ms(lambda: ws4_g1_forced(dev, consts, sub, d, G, out), 5))
        res[Kp] = {G: sum(t) / len(t) for G, t in ms.items()}
        res[f"{Kp}_runs"] = ms
    emit({"phase": "ws4_g1_groups", "lanes": WG * B, "rule_groups": rules,
          "ms": {k: v for k, v in res.items() if isinstance(k, int)},
          "ms_runs": {k: v for k, v in res.items() if not isinstance(k, int)}})
    return res


def ragged_horner4(dev, curve: str, consts, sums) -> None:
    """horner4 G1 or G2 at ragged lane counts B in {1, 5, 6, 257} (a warp's
    five groups, one group past them, a last warp of two groups), the
    accumulator and window sums taken from the lanes of ``sums``
    (window_sum4 outputs, reused in turn) with lane 0's accumulator the
    identity, limb for limb against the plain version; one kernel_check line
    each (not in the kernels line). B = 1 is one lane's chain of 36
    dependent cooperative padds alone on the card, so its time over 36 is a
    padd's latency."""
    from libzkp_tpu_torch.ops import kernels
    from libzkp_tpu_torch.ops.weierstrass import get_engine

    eng = get_engine(curve)
    C, n, L = sums.shape
    for B in (1, 5, 6, 257):
        acc = sums[..., torch.arange(B, device=dev) % L].contiguous()
        acc[..., 0] = eng.identity(1, dev)[..., 0]
        wsums = sums[..., (torch.arange(kernels.WIN_GROUP * B, device=dev) + B) % L].contiguous()
        got = kernels.horner4(consts, acc, wsums, curve=curve)
        want = kernels.horner4_plain(consts, acc, wsums, curve=curve)
        torch.cuda.synchronize()
        err = _limbs_err(f"horner4 {curve} at B {B}", got, want)
        row = {"phase": "kernel_check", "name": kernels.instance("horner4", curve), "ragged": True,
               "max_abs_err": float(err), "tolerance": "exact limbs",
               "shape": f"acc ({C},{n},{B}), wsums ({C},{n},{kernels.WIN_GROUP * B}) i32"}
        if B == 1:
            ms = cuda_ms(lambda: kernels.horner4(consts, acc, wsums, curve=curve), 20)
            row |= {"ms": ms, "chained_padds": kernels.WIN_GROUP * 9,
                    "padd_latency_us": ms * 1e3 / (kernels.WIN_GROUP * 9)}
        emit(row)


# ragged_pair_add's lane counts (timed ones): G2, one 18-thread group a
# one-warp block, 353 one lane past the b_g2 table's basis; G1, five groups
# a warp, 8 the grouped route's statement tables, 512 the h query's table
RAGGED_PAIR_ADD = {"bn254_g2": ((1, 5, 6, 128, 353), (1,)), "bn254_g1": ((1, 5, 6, 8, 128, 512), (8, 512)),
                   "ed25519": ((1, 7, 8, 9, KP + 1), ())}


def ragged_pair_add(dev, curve: str, consts, table, baseT, horners) -> None:
    """pair_add at ragged lane counts (RAGGED_PAIR_ADD), limb for
    limb against the plain version, on the operands the paths give it: a
    table build step, row d of basis point k % Kp of ``table`` plus its base
    point from ``baseT`` (lane 0: the identity plus the base; lane 1: row 1
    plus the base, the build's doubling at step 2), and in every third lane
    from lane 2 two lanes of ``horners`` (horner4 outputs) as the mesh fold
    adds partial sums; one kernel_check line each (not in the kernels line).
    G2's K = 1 is one cooperative padd alone on the card: its time is a
    launch's latency; G1's K = 8 is a grouped-route table build step."""
    from libzkp_tpu_torch.ops import kernels

    Kp, C, n = baseT.shape[-1], table.shape[1], table.shape[2]
    L = horners.shape[-1]
    sizes, timed = RAGGED_PAIR_ADD[curve]
    for K in sizes:
        k = torch.arange(K, device=dev) % Kp
        d = torch.randint(0, 255, (K,), generator=torch.Generator().manual_seed(K)).to(dev)
        d[:2] = torch.tensor([0, 1], device=dev)[:K]
        p = table[k * 256 + d].permute(1, 2, 0).to(torch.int32).contiguous()
        q = baseT[..., k].contiguous()
        fold = torch.arange(K, device=dev)[2::3]
        p[..., fold] = horners[..., fold % L]
        q[..., fold] = horners[..., (fold + 1) % L]
        got = kernels.pair_add(consts, p, q, curve=curve)
        want = kernels.pair_add_plain(consts, p, q, curve=curve)
        torch.cuda.synchronize()
        err = _limbs_err(f"pair_add {curve} at K {K}", got, want)
        row = {"phase": "kernel_check", "name": kernels.instance("pair_add", curve), "ragged": True,
               "max_abs_err": float(err), "tolerance": "exact limbs", "shape": f"p, q ({C},{n},{K}) i32"}
        if K in timed:
            row["ms"] = cuda_ms(lambda: kernels.pair_add(consts, p, q, curve=curve), 200)
            row["plain_ms"] = cuda_ms(lambda: kernels.pair_add_plain(consts, p, q, curve=curve), 10)
        emit(row)


def check_bn254_kernels(dev, int_rate: float, tables: dict) -> list:
    """Phase 3b: pair_add, window_sum4 and horner4 for BN254 G1 and G2
    against their plain versions at the Groth16 prover's shapes: 256
    statements, so 4 * 256 window-sum lanes; Kp = 512 (G1, the h query) and
    352 (G2, the b_g2 query). window_sum4 sums in the plain tree's order,
    so both curves are held limb for limb (and by point equality), here and
    at ragged shapes (:func:`g1_ragged_window_sum4`, against its order model
    too, and :func:`g2_ragged_window_sum4`); G1 also at every G near the
    rule's at Kp 512 and 352 (:func:`ws4_g1_groups`) and timed at the
    grouped route's Kp = 8, 128 lanes. horner4 is held limb for limb, also
    at ragged lane counts (:func:`ragged_horner4`), and pair_add too, also
    at ragged lane counts (:func:`ragged_pair_add`). Leaves each table in
    ``tables[curve]``."""
    import numpy as np

    from libzkp_tpu_torch.ops import kernels
    from libzkp_tpu_torch.ops.weierstrass import get_engine

    results = []
    rng = random.Random(20261017)
    B = G16_LANES
    WG = kernels.WIN_GROUP
    for curve in ("bn254_g1", "bn254_g2"):
        eng = get_engine(curve)
        C, n = eng.coords, eng.n
        Kp = BN_KP[curve]
        consts = torch.from_numpy(eng.consts_np).to(dev)
        baseT = torch.from_numpy(np.ascontiguousarray(np.transpose(
            eng.encode_points(_random_points(curve, Kp, rng)), (1, 2, 0)))).to(dev)
        acc = eng.identity(Kp, dev)
        rows = [acc]
        for _ in range(255):
            acc = kernels.pair_add_plain(consts, acc, baseT, curve=curve)
            rows.append(acc)
        table = torch.stack(rows).permute(3, 0, 1, 2).reshape(Kp * 256, C, n).to(torch.int16).contiguous()
        digits = torch.randint(0, 256, (WG, Kp, B), generator=torch.Generator().manual_seed(8),
                               dtype=torch.int32).to(dev)
        tables[curve] = (consts, table, Kp)
        padd = WPADD_MACS[curve]

        def plain4():
            return window_sum4_plain_chunked(consts, table, digits, curve)

        ws_k = kernels.window_sum4(consts, table, digits, curve=curve)
        ws_p = plain4()
        torch.cuda.synchronize()
        err = _weierstrass_point_err(curve, ws_k, ws_p)
        if err != 0:
            raise AssertionError(f"window_sum4 {curve} disagrees with its plain version (point err {err})")
        err = _limbs_err(f"window_sum4 {curve}", ws_k, ws_p)  # the plain tree's order
        tolerance = "exact limbs, and projective equality and the curve equation"
        extra = {}
        if curve == "bn254_g2":
            g2_ragged_window_sum4(dev, consts, table)
        else:
            g1_ragged_window_sum4(dev, consts, table)
            ws4_g1_groups(dev, consts, table, digits, {
                k: ws_p if k == Kp else window_sum4_plain_chunked(consts, table[:k * 256],
                                                                  digits[:, :k].contiguous(), curve)
                for k in G1_KPS})
            # the grouped route's statement tables: Kp = 8, 32 proofs (128 lanes)
            sub, d8 = table[:8 * 256], digits[:, :8, :32].contiguous()
            got8 = kernels.window_sum4(consts, sub, d8, curve=curve)
            want8 = kernels.window_sum4_plain(consts, sub, d8, curve=curve)
            torch.cuda.synchronize()
            emit({"phase": "kernel_check", "name": kernels.instance("window_sum4", curve), "grouped": True,
                  "max_abs_err": float(_limbs_err(f"window_sum4 {curve} at Kp 8", got8, want8)),
                  "tolerance": "exact limbs", "shape": "table (2048,3,24) i16, digits (4,8,32) i32",
                  "ms": cuda_ms(lambda: kernels.window_sum4(consts, sub, d8, curve=curve), 50),
                  "plain_ms": cuda_ms(lambda: kernels.window_sum4_plain(consts, sub, d8, curve=curve), 5)})
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            extra["groups"] = kernels.window_sum4_g1_geometry(Kp, WG * B, sms)[0]
        t_k = cuda_ms(lambda: kernels.window_sum4(consts, table, digits, curve=curve), 5)
        t_p = cuda_ms(plain4, 1)
        b_ms, b_by = bound((Kp - 1) * padd * WG * B,
                           table.numel() * 2 + digits.numel() * 4 + C * n * WG * B * 4, int_rate)
        results.append(dict(name=kernels.instance("window_sum4", curve), route="cuda",
                            source="libzkp_tpu_torch/csrc/window_sum4.cu",
                            replaces="libzkp_tpu/ops/curve_jax.py:737",
                            max_abs_err=float(err), tolerance=tolerance,
                            ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                            shape=f"table ({Kp * 256},{C},{n}) i16, digits ({WG},{Kp},{B}) i32", **extra))

        acc_in = ws_k[..., :B].contiguous()
        wsums = ws_p
        h_k = kernels.horner4(consts, acc_in, wsums, curve=curve)
        h_p = kernels.horner4_plain(consts, acc_in, wsums, curve=curve)
        torch.cuda.synchronize()
        err = int((h_k - h_p).abs().max())
        if err != 0:
            raise AssertionError(f"horner4 {curve} limbs differ from its plain version (max {err})")
        ragged_horner4(dev, curve, consts, ws_p)
        t_k = cuda_ms(lambda: kernels.horner4(consts, acc_in, wsums, curve=curve), 5)
        t_p = cuda_ms(lambda: kernels.horner4_plain(consts, acc_in, wsums, curve=curve), 2)
        b_ms, b_by = bound(WG * 9 * padd * B, (2 + WG) * C * n * B * 4, int_rate)
        results.append(dict(name=kernels.instance("horner4", curve), route="cuda",
                            source="libzkp_tpu_torch/csrc/horner4.cu",
                            replaces="libzkp_tpu/ops/curve_jax.py:841",
                            max_abs_err=float(err), tolerance="exact limbs",
                            ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                            shape=f"acc ({C},{n},{B}), wsums ({C},{n},{WG * B}) i32"))

        p = table.view(Kp, 256, C, n)[:, 7].permute(1, 2, 0).to(torch.int32).contiguous()
        q = table.view(Kp, 256, C, n)[:, 200].permute(1, 2, 0).to(torch.int32).contiguous()
        a_k = kernels.pair_add(consts, p, q, curve=curve)
        a_p = kernels.pair_add_plain(consts, p, q, curve=curve)
        torch.cuda.synchronize()
        err = int((a_k - a_p).abs().max())
        if err != 0:
            raise AssertionError(f"pair_add {curve} limbs differ from its plain version (max {err})")
        ragged_pair_add(dev, curve, consts, table, baseT, h_k)
        t_k = cuda_ms(lambda: kernels.pair_add(consts, p, q, curve=curve), 50)
        t_p = cuda_ms(lambda: kernels.pair_add_plain(consts, p, q, curve=curve), 10)
        b_ms, b_by = bound(padd * Kp, 3 * C * n * Kp * 4, int_rate)
        results.append(dict(name=kernels.instance("pair_add", curve), route="cuda",
                            source="libzkp_tpu_torch/csrc/pair_add.cu",
                            replaces="libzkp_tpu/ops/curve_jax.py:482",
                            max_abs_err=float(err), tolerance="exact limbs",
                            ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                            shape=f"p, q ({C},{n},{Kp}) i32"))
    for r in results:
        emit({"phase": "kernel_check", **r})
    return results


def check_membership_shapes(dev, int_rate: float) -> None:
    """Phase 3f: pair_add, window_sum4 and horner4 for BN254 G1 and G2
    against their plain versions at the membership path's shapes
    (MEM_LANES statements): window_sum4 G1 at Kp 608, 1024 and 480 (the a
    and b_g1, h, and l queries) and G2 at Kp 608 (b_g2), horner4 on each
    group's sums, pair_add at each Kp (a step of the table builds), limb for
    limb and timed; one kernel_check line each, with ``"membership": true``
    (the kernels line keeps the equality path's shapes)."""
    import numpy as np

    from libzkp_tpu_torch.ops import kernels
    from libzkp_tpu_torch.ops.weierstrass import get_engine

    rng = random.Random(20261019)
    B, WG = MEM_LANES, kernels.WIN_GROUP
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for curve, kps in (("bn254_g1", MEM_G1_KPS), ("bn254_g2", (MEM_G2_KP,))):
        eng = get_engine(curve)
        C, n = eng.coords, eng.n
        K = max(kps)
        consts = torch.from_numpy(eng.consts_np).to(dev)
        baseT = torch.from_numpy(np.ascontiguousarray(np.transpose(
            eng.encode_points(_random_points(curve, K, rng)), (1, 2, 0)))).to(dev)
        acc = eng.identity(K, dev)
        rows = [acc]
        for _ in range(255):
            acc = kernels.pair_add_plain(consts, acc, baseT, curve=curve)
            rows.append(acc)
        table = torch.stack(rows).permute(3, 0, 1, 2).reshape(K * 256, C, n).to(torch.int16).contiguous()
        padd = WPADD_MACS[curve]
        for Kp in kps:
            sub = table[:Kp * 256]
            digits = torch.randint(0, 256, (WG, Kp, B), generator=torch.Generator().manual_seed(Kp),
                                   dtype=torch.int32).to(dev)
            got = kernels.window_sum4(consts, sub, digits, curve=curve)
            want = window_sum4_plain_chunked(consts, sub, digits, curve)
            torch.cuda.synchronize()
            err = _limbs_err(f"window_sum4 {curve} at Kp {Kp}", got, want)
            b_ms, b_by = bound((Kp - 1) * padd * WG * B, sub.numel() * 2 + digits.numel() * 4 + C * n * WG * B * 4,
                               int_rate)
            extra = {"groups": kernels.window_sum4_g1_geometry(Kp, WG * B, sms)[0]} if curve == "bn254_g1" else {}
            emit({"phase": "kernel_check", "name": kernels.instance("window_sum4", curve), "membership": True,
                  "max_abs_err": float(err), "tolerance": "exact limbs",
                  "shape": f"table ({Kp * 256},{C},{n}) i16, digits ({WG},{Kp},{B}) i32",
                  "ms": cuda_ms(lambda: kernels.window_sum4(consts, sub, digits, curve=curve), 5),
                  "plain_ms": cuda_ms(lambda: window_sum4_plain_chunked(consts, sub, digits, curve), 1),
                  "bound_ms": b_ms, "bound_by": b_by, **extra})

            acc_in = got[..., :B].contiguous()
            h_k = kernels.horner4(consts, acc_in, got, curve=curve)
            h_p = kernels.horner4_plain(consts, acc_in, got, curve=curve)
            torch.cuda.synchronize()
            err = _limbs_err(f"horner4 {curve} after Kp {Kp}", h_k, h_p)
            b_ms, b_by = bound(WG * 9 * padd * B, (2 + WG) * C * n * B * 4, int_rate)
            emit({"phase": "kernel_check", "name": kernels.instance("horner4", curve), "membership": True,
                  "max_abs_err": float(err), "tolerance": "exact limbs",
                  "shape": f"acc ({C},{n},{B}), wsums ({C},{n},{WG * B}) i32 (Kp {Kp})",
                  "ms": cuda_ms(lambda: kernels.horner4(consts, acc_in, got, curve=curve), 5),
                  "plain_ms": cuda_ms(lambda: kernels.horner4_plain(consts, acc_in, got, curve=curve), 2),
                  "bound_ms": b_ms, "bound_by": b_by})

            p = sub.view(Kp, 256, C, n)[:, 7].permute(1, 2, 0).to(torch.int32).contiguous()
            q = sub.view(Kp, 256, C, n)[:, 200].permute(1, 2, 0).to(torch.int32).contiguous()
            a_k = kernels.pair_add(consts, p, q, curve=curve)
            a_p = kernels.pair_add_plain(consts, p, q, curve=curve)
            torch.cuda.synchronize()
            err = _limbs_err(f"pair_add {curve} at K {Kp}", a_k, a_p)
            b_ms, b_by = bound(padd * Kp, 3 * C * n * Kp * 4, int_rate)
            emit({"phase": "kernel_check", "name": kernels.instance("pair_add", curve), "membership": True,
                  "max_abs_err": float(err), "tolerance": "exact limbs", "shape": f"p, q ({C},{n},{Kp}) i32",
                  "ms": cuda_ms(lambda: kernels.pair_add(consts, p, q, curve=curve), 50),
                  "plain_ms": cuda_ms(lambda: kernels.pair_add_plain(consts, p, q, curve=curve), 10),
                  "bound_ms": b_ms, "bound_by": b_by})


def g1_pair(dev) -> None:
    """window_sum4 G1 and pair_add G1 alone, through the wrappers and the
    plain versions only, so that this function also runs on an earlier
    checkout (this script copied into it) for timings paired in one call:
    window_sum4 at Kp 512 and 352 (1024 lanes, the Groth16 batch) and 8 (128
    lanes, a grouped-route statement table), pair_add at K 8 and 512, each
    held by point equality against its plain version (limbs reported, not
    required); one g1_pair line."""
    import numpy as np

    from libzkp_tpu_torch.ops import kernels
    from libzkp_tpu_torch.ops.weierstrass import get_engine

    curve, Kp, WG = "bn254_g1", BN_KP["bn254_g1"], 4
    eng = get_engine(curve)
    consts = torch.from_numpy(eng.consts_np).to(dev)
    baseT = torch.from_numpy(np.ascontiguousarray(np.transpose(
        eng.encode_points(_random_points(curve, Kp, random.Random(20261017))), (1, 2, 0)))).to(dev)
    acc, rows = eng.identity(Kp, dev), []
    for _ in range(256):
        rows.append(acc)
        acc = kernels.pair_add_plain(consts, acc, baseT, curve=curve)
    table = torch.stack(rows).permute(3, 0, 1, 2).reshape(Kp * 256, 3, 24).to(torch.int16).contiguous()
    digits = torch.randint(0, 256, (WG, Kp, G16_LANES), generator=torch.Generator().manual_seed(8),
                           dtype=torch.int32).to(dev)
    out: dict = {"card": smi("name,power.limit")}
    # the Groth16 batch; a grouped-route statement table (32 proofs); the h
    # query at the grouped route's 8 statements
    for k, lanes in ((G1_KPS[0], G16_LANES), (G1_KPS[1], G16_LANES), (8, 32), (G1_KPS[0], 8)):
        sub, d = table[:k * 256], digits[:, :k, :lanes].contiguous()
        got = kernels.window_sum4(consts, sub, d, curve=curve)
        want = window_sum4_plain_chunked(consts, sub, d, curve)
        torch.cuda.synchronize()
        if _weierstrass_point_err(curve, got, want) != 0:
            raise AssertionError(f"window_sum4 {curve} at Kp {k} disagrees with its plain version")
        key = f"window_sum4_kp{k}_b{d.shape[-1]}"
        out[key] = {"ms": cuda_ms(lambda: kernels.window_sum4(consts, sub, d, curve=curve), 20),
                    "lanes": WG * d.shape[-1], "limbs_equal": bool(torch.equal(got, want))}
        if hasattr(kernels, "window_sum4_g1_geometry") and k != 8:  # this tree's design: G nodes a lane
            sweep = {}
            for G in [k] + [G for G in _node_counts(k) if G >= 8][-5:]:
                ws4_g1_forced(dev, consts, sub, d, G, got)
                torch.cuda.synchronize()
                _limbs_err(f"window_sum4 {curve} at Kp {k}, G {G}", got, want)
                sweep[G] = cuda_ms(lambda: ws4_g1_forced(dev, consts, sub, d, G, got), 10)
            out[key]["ms_by_groups"] = sweep
    for K in (8, Kp):
        p = table.view(Kp, 256, 3, 24)[:K, 7].permute(1, 2, 0).to(torch.int32).contiguous()
        q = baseT[..., :K].contiguous()
        got = kernels.pair_add(consts, p, q, curve=curve)
        want = kernels.pair_add_plain(consts, p, q, curve=curve)
        torch.cuda.synchronize()
        if _weierstrass_point_err(curve, got, want) != 0:
            raise AssertionError(f"pair_add {curve} at K {K} disagrees with its plain version")
        out[f"pair_add_k{K}"] = {"ms": cuda_ms(lambda: kernels.pair_add(consts, p, q, curve=curve), 200),
                                 "limbs_equal": bool(torch.equal(got, want))}
    emit({"phase": "g1_pair", **out})


def _point_err(curve: str, a, b) -> int:
    return _edwards_point_err(a, b) if curve == "ed25519" else _weierstrass_point_err(curve, a, b)


# ragged_tree_sum's shapes (B lanes, k points): the ragged edges of a
# block's tree, then B = 128 at the mesh's other block shapes (G2: the b_g2
# query's k_local at shard 4 and 8; G1: the a, b_g1, l queries' at shard 2,
# the h query's at shard 4, the a, b_g1, l queries' at shard 4, both at 8;
# ed25519: the range basis's at shard 4 and 8)
RAGGED_TREE_SHAPES = {
    "ed25519": [(B, k) for B in (1, 127) for k in (1, 2, 3, 95)] + [(SHARD_B_LOCAL, 40), (SHARD_B_LOCAL, 20)],
    "bn254_g2": [(B, k) for B in (1, 127) for k in (1, 2, 3, 191)] + [(SHARD_B_LOCAL, 96), (SHARD_B_LOCAL, 64)],
    "bn254_g1": [(B, k) for B in (1, 127) for k in (1, 2, 3, 255)]
                + [(SHARD_B_LOCAL, k) for k in (192, 128, 96, 64)],
}


def ragged_tree_sum(dev, curve: str, consts, table, table_kp: int) -> None:
    """tree_sum at RAGGED_TREE_SHAPES[curve], on rows gathered from the
    path's table, limb for limb and point for point against the plain
    version; one kernel_check line each (not in the kernels line)."""
    from libzkp_tpu_torch.ops import kernels

    C, n = table.shape[1:]
    for B, k in RAGGED_TREE_SHAPES[curve]:
        digits = torch.randint(0, 256, (B, k), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(1000 * B + k)).to(dev)
        koff = (torch.arange(k, device=dev, dtype=torch.int64) % table_kp) * 256
        pts = table[digits.to(torch.int64) + koff].contiguous()  # (B, k, C, n) int16
        got = kernels.tree_sum(consts, pts, curve=curve)
        want = kernels.tree_sum_plain(consts, pts, curve=curve)
        torch.cuda.synchronize()
        err = _limbs_err(f"tree_sum {curve} at B {B}, k {k}", got, want)
        if _point_err(curve, got, want) != 0:
            raise AssertionError(f"tree_sum {curve} at B {B}, k {k} disagrees with its plain version")
        emit({"phase": "kernel_check", "name": kernels.instance("tree_sum", curve), "ragged": True,
              "max_abs_err": float(err), "tolerance": "exact limbs and point equality",
              "shape": f"pts ({B},{k},{C},{n}) i16"})


def ragged_horner(dev, curve: str, consts, sums, lane_counts=(1, 5, 6, 127, 129)) -> None:
    """horner at ragged lane counts: G1 and G2 at B in {1, 5, 6, 127, 129}
    (G1: a warp's five six-thread groups, one group past them, a partial
    last block; G2, one 18-thread group a warp: as many one-warp blocks;
    both: one lane past the mesh block's 128), ed25519 at B in {1, 7, 8, 9,
    1023} (eight four-thread groups a warp: short of them, one past, a
    partial last warp at the path's 1024), the accumulator and window sum
    taken from the lanes of ``sums`` (tree_sum or window_sum outputs, reused
    in turn) with lane 0's accumulator the identity, limb for limb against
    the plain version; one kernel_check line each (not in the kernels line).
    B = 1 is one lane's chain of 9 dependent cooperative steps alone on the
    card, so its time over 9 is a step's latency."""
    from libzkp_tpu_torch.ops import kernels
    from libzkp_tpu_torch.ops.weierstrass import get_engine

    eng = get_engine(curve)
    C, n, L = sums.shape
    for B in lane_counts:
        acc = sums[..., torch.arange(B, device=dev) % L].contiguous()
        acc[..., 0] = eng.identity(1, dev)[..., 0]
        wsum = sums[..., (torch.arange(B, device=dev) + B) % L].contiguous()
        got = kernels.horner(consts, acc, wsum, curve=curve)
        want = kernels.horner_plain(consts, acc, wsum, curve=curve)
        torch.cuda.synchronize()
        err = _limbs_err(f"horner {curve} at B {B}", got, want)
        row = {"phase": "kernel_check", "name": kernels.instance("horner", curve), "ragged": True,
               "max_abs_err": float(err), "tolerance": "exact limbs", "shape": f"acc, wsum ({C},{n},{B}) i32"}
        if B == 1:
            ms = cuda_ms(lambda: kernels.horner(consts, acc, wsum, curve=curve), 50)
            row |= {"ms": ms, "chained_padds": 9, "padd_latency_us": ms * 1e3 / 9}
        emit(row)


def check_sharded_kernels(dev, int_rate: float, tables: dict) -> list:
    """Phase 3c: the kernels of one block of the mesh-sharded Groth16 MSMs
    (dp = shard = 2: 128 lanes per block; 256 basis points per block for the
    h query, 192 for the 334- and 332-point queries, 96 for phase 7's
    ed25519 MSM over the range basis): tree_sum for every curve on rows
    gathered from the tables of phases 3 and 3b, limb for limb and by point
    equality (a lane of no point fails), here and at ragged shapes
    (:func:`ragged_tree_sum`); horner for BN254 G1 and G2, limb for limb,
    here and at ragged lane counts (:func:`ragged_horner`)."""
    from libzkp_tpu_torch.ops import kernels
    from libzkp_tpu_torch.ops.weierstrass import CURVES

    results = []
    for i, curve in enumerate(CURVES):
        consts, table, table_kp = tables[curve]
        C, n = table.shape[1:]
        k = SHARD_K_LOCAL[curve]
        digits = torch.randint(0, 256, (k, SHARD_B_LOCAL), generator=torch.Generator().manual_seed(9 + i),
                               dtype=torch.int32).to(dev)
        koff = (torch.arange(k, device=dev, dtype=torch.int64) % table_kp) * 256
        pts = table[digits.T.to(torch.int64) + koff].contiguous()  # (B, k, C, n) int16
        ts_k = kernels.tree_sum(consts, pts, curve=curve)
        ts_p = kernels.tree_sum_plain(consts, pts, curve=curve)
        torch.cuda.synchronize()
        if _point_err(curve, ts_k, ts_p) != 0:
            raise AssertionError(f"tree_sum {curve} disagrees with its plain version")
        err = _limbs_err(f"tree_sum {curve}", ts_k, ts_p)
        ragged_tree_sum(dev, curve, consts, table, table_kp)
        t_k = cuda_ms(lambda: kernels.tree_sum(consts, pts, curve=curve), 20)
        t_p = cuda_ms(lambda: kernels.tree_sum_plain(consts, pts, curve=curve), 2)
        padd = CURVE_PADD_MACS[curve]
        b_ms, b_by = bound((k - 1) * padd * SHARD_B_LOCAL, pts.numel() * 2 + C * n * SHARD_B_LOCAL * 4,
                           int_rate)
        results.append(dict(name=kernels.instance("tree_sum", curve), route="cuda",
                            source="libzkp_tpu_torch/csrc/tree_sum.cu",
                            replaces="libzkp_tpu/ops/curve_jax.py:364",
                            max_abs_err=float(err), tolerance="exact limbs, and point equality",
                            ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                            card_us=card_time(lambda: kernels.tree_sum(consts, pts, curve=curve),
                                              TREE_SUM_KERNELS[curve], 20)["kernel_us"],
                            shape=f"pts ({SHARD_B_LOCAL},{k},{C},{n}) i16"))
        if curve == "ed25519":
            continue
        acc_in, wsum = ts_k, ts_p
        h_k = kernels.horner(consts, acc_in, wsum, curve=curve)
        h_p = kernels.horner_plain(consts, acc_in, wsum, curve=curve)
        torch.cuda.synchronize()
        err = int((h_k - h_p).abs().max())
        if err != 0:
            raise AssertionError(f"horner {curve} limbs differ from its plain version (max {err})")
        ragged_horner(dev, curve, consts, ts_p)
        t_k = cuda_ms(lambda: kernels.horner(consts, acc_in, wsum, curve=curve), 20)
        t_p = cuda_ms(lambda: kernels.horner_plain(consts, acc_in, wsum, curve=curve), 3)
        b_ms, b_by = bound(9 * padd * SHARD_B_LOCAL, 3 * C * n * SHARD_B_LOCAL * 4, int_rate)
        results.append(dict(name=kernels.instance("horner", curve), route="cuda",
                            source="libzkp_tpu_torch/csrc/horner.cu",
                            replaces="libzkp_tpu/ops/curve_jax.py:431",
                            max_abs_err=float(err), tolerance="exact limbs",
                            ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                            shape=f"acc, wsum ({C},{n},{SHARD_B_LOCAL}) i32"))
    for r in results:
        emit({"phase": "kernel_check", **r})
    return results


def check_probe_kernels(dev, int_rate: float, fp32_rate: float) -> list:
    """Phase 3d: the probe kernels at the probes' shapes, limb for limb
    against their plain versions: padd_chain (P2, 64 chained additions over
    512 lanes), fe_mul for both fields (P4, 2^20 lanes), and K3 pair_add at
    P5's shape (2^18 lanes; emitted, not returned: K3's row in the kernels
    line stays at the range path's shape); mont_padd (P7, 2^18 lanes), the
    five fold_ablate variants (P1, 2^20 lanes, n = 24) and padd_f32_chain
    (P3, 64 chained additions over 512 lanes; float32, exact, so limb for
    limb too, its bound at the FP32 rate)."""
    from libzkp_tpu_torch import probes
    from libzkp_tpu_torch.ops import kernels

    def check(name, source, replaces, run, plain, iters, macs, nbytes, shape, rate=int_rate, card=None,
              **extra):
        out_k, out_p = run(), plain()
        torch.cuda.synchronize()
        err = float((out_k - out_p).abs().max())
        if err != 0:
            raise AssertionError(f"{name} limbs differ from its plain version (max {err})")
        b_ms, b_by = bound(macs, nbytes, rate)
        if card:  # the card's time a launch (profiler)
            extra["card"] = card_time(run, card, iters)
        row = dict(name=name, route="cuda", source=source, replaces=replaces, max_abs_err=float(err),
                   tolerance="exact limbs", ms=cuda_ms(run, iters), plain_ms=cuda_ms(plain, 1),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=shape, **extra)
        emit({"phase": "kernel_check", **row})
        return row

    R = probes.CHAIN_R
    consts, p, q, _, _ = probes.chain_inputs(dev)
    lanes = p.shape[-1]
    results = [check("padd_chain", "libzkp_tpu_torch/csrc/probes.cu", "scripts/bench_pallas_padd.py:65",
                     lambda: kernels.padd_chain(consts, p, q, R),
                     lambda: kernels.padd_chain_plain(consts, p, q, R), 20,
                     R * PADD_MACS * lanes, 3 * p.numel() * 4, f"p, q (4,24,{lanes}) i32, chain {R}",
                     card=CHAIN_KERNELS)]
    for curve in ("ed25519", "bn254_g1"):
        mc, a, b, _, _ = probes.mul_inputs(dev, curve)
        results.append(check(
            kernels.instance("fe_mul", curve), "libzkp_tpu_torch/csrc/probes.cu",
            "scripts/bench_fold.py:138",
            lambda: kernels.fe_mul(mc, a, b, curve=curve),
            lambda: kernels.fe_mul_plain(mc, a, b, curve=curve), 50,
            (ED_MUL_MACS if curve == "ed25519" else BN_MUL_MACS) * a.shape[-1], 3 * a.numel() * 4,
            f"a, b (24,{a.shape[-1]}) i32", card=FE_MUL_KERNELS))
        ragged_fe_mul(dev, curve, mc, a, b)
    consts, p, q, _, _ = probes.add_inputs(dev)
    check("pair_add", "libzkp_tpu_torch/csrc/pair_add.cu", "scripts/bench_fold.py:185",
          lambda: kernels.pair_add(consts, p, q), lambda: kernels.pair_add_plain(consts, p, q), 20,
          PADD_MACS * p.shape[-1], 3 * p.numel() * 4, f"p, q (4,24,{p.shape[-1]}) i32",
          card=PAIR_ADD_ED_KERNELS, probe="P5")
    # P7, P1, P3
    mc, mp, mq, _, _ = probes.mont_padd_inputs(dev)
    E = mp.shape[-1]
    results.append(check("mont_padd", "libzkp_tpu_torch/csrc/probes.cu", "scripts/bench_pallas_mul.py:149",
                         lambda: kernels.mont_padd(mc, mp, mq), lambda: kernels.mont_padd_plain(mc, mp, mq),
                         20, 9 * MONT_MACS * E, 3 * mp.numel() * 4, f"p, q (4,22,{E}) i32, 2^255-19",
                         card=MONT_PADD_KERNELS))
    for v in kernels.ABLATE_VARIANTS:
        ac, aa, ab = probes.ablate_inputs(dev, v)
        L = aa.shape[-1]
        results.append(check(
            kernels.instance("fold_ablate", v), "libzkp_tpu_torch/csrc/probes.cu",
            "scripts/bench_ablate.py:101",
            lambda: kernels.fold_ablate(ac, aa, ab, variant=v),
            lambda: kernels.fold_ablate_plain(ac, aa, ab, variant=v), 50,
            probes.ABLATE_OPS[v](ac.shape[1]) * L, (aa.numel() + (ab.numel() if ab is not None else 0)
                                                    + ac.shape[1] * L) * 4,
            f"a ({aa.shape[0]},{L}){'' if ab is None else f', b ({ab.shape[0]},{L})'} i32, n = 24"))
    fc, fp, fq, _, _ = probes.f32_chain_inputs(dev)
    B = fp.shape[-1]
    results.append(check("padd_f32_chain", "libzkp_tpu_torch/csrc/probes.cu",
                         "scripts/bench_pallas_padd.py:220",
                         lambda: kernels.padd_f32_chain(fc, fp, fq, R),
                         lambda: kernels.padd_f32_chain_plain(fc, fp, fq, R), 10,
                         R * 9 * F32_MUL_FMAS * B, 3 * fp.numel() * 4,
                         f"p, q (4,29,{B}) f32, chain {R}", rate=fp32_rate, card=F32_CHAIN_KERNELS))
    return results


def ragged_fe_mul(dev, curve: str, consts, a, b) -> None:
    """fe_mul at FE_MUL_RAGGED lanes, from bases not 16-byte aligned (``a``
    and ``b`` copied to word 1 of a buffer) and chained on its own output
    (relaxed operands: fe_mul(fe_mul(a, b), a)), each limb for limb against
    its plain version. One kernel_check line with "ragged": true."""
    from libzkp_tpu_torch import probes
    from libzkp_tpu_torch.ops import kernels

    name = kernels.instance("fe_mul", curve)
    cases = [(f"E {E}",) + probes.mul_inputs(dev, curve, E, seed=E)[1:3] for E in FE_MUL_RAGGED]
    n, E = a.shape
    moved = []
    for x in (a, b):
        m = torch.empty(n * E + 1, dtype=torch.int32, device=dev)[1:].view(n, E)
        m.copy_(x)
        moved.append(m)
    cases.append((f"E {E}, bases not 16-byte aligned", *moved))
    for tag, x, y in cases:
        _limbs_err(f"{name} at {tag}", kernels.fe_mul(consts, x, y, curve=curve),
                   kernels.fe_mul_plain(consts, x, y, curve=curve))
    chained = kernels.fe_mul(consts, kernels.fe_mul(consts, a, b, curve=curve), a, curve=curve)
    plain = kernels.fe_mul_plain(consts, kernels.fe_mul_plain(consts, a, b, curve=curve), a, curve=curve)
    _limbs_err(f"{name} chained", chained, plain)
    emit({"phase": "kernel_check", "name": name, "ragged": True, "max_abs_err": 0.0,
          "tolerance": "exact limbs", "cases": [c[0] for c in cases] + [f"E {E}, fe_mul(fe_mul(a, b), a)"]})


def sass_counts(lib: str, names: tuple) -> dict:
    """Per kernel of the built library ``lib`` whose mangled name holds one
    of ``names``, counted in ``cuobjdump -sass``: instructions, IMADs (the
    plain multiply-add), IMADs with an immediate operand, LDC instructions
    and operands in constant bank 3 (``__constant__``; bank 0 holds the
    kernel's parameters)."""
    import re
    import shutil

    from libzkp_tpu_torch.ops import kernels

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(kernels.build()[lib])], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1) if any(x in m.group(1) for x in names) else None
            if cur:
                out[cur] = dict.fromkeys(("instructions", "imad", "imad_immediate", "ldc", "const_bank3"), 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);", ln)
        if cur is None or not m:
            continue
        op, args = m.groups()
        c = out[cur]
        c["instructions"] += 1
        c["ldc"] += op.split(".")[0] == "LDC"
        c["const_bank3"] += "c[0x3]" in args
        if op == "IMAD":
            c["imad"] += 1
            c["imad_immediate"] += "0x" in re.sub(r"c\[0x[0-9a-f]+\]\[[^]]*\]", "", args)
    return out


def fe_mul_pair(dev) -> None:
    """P4 fe_mul alone at its probe's shape (2^20 lanes), both fields,
    through its wrapper: limb for limb against its plain version, timed
    (CUDA events, three runs) with the card's time a launch (profiler).
    Where the probes library has ``fe_mul_bn254_g1_c_consts_launch`` (this
    tree), also BN254 Fq's product with its constants in the code against
    the same product on the consts block in __constant__, at the same loads
    and block size, in turns (FE_MUL_ABLATION), each checked limb for limb
    at 2^20, 2^20 - 100 and 100 lanes before it is first timed; and the
    SASS of every fe_mul kernel counted (:func:`sass_counts`). Runs on an
    earlier checkout too. One fe_mul line."""
    import ctypes

    from libzkp_tpu_torch import probes
    from libzkp_tpu_torch.ops import kernels

    out = {"card": smi("name,power.limit")}
    for curve in ("ed25519", "bn254_g1"):
        mc, a, b, _, _ = probes.mul_inputs(dev, curve)
        _limbs_err(kernels.instance("fe_mul", curve), kernels.fe_mul(mc, a, b, curve=curve),
                   kernels.fe_mul_plain(mc, a, b, curve=curve))
        run = lambda: kernels.fe_mul(mc, a, b, curve=curve)  # noqa: E731
        out[curve] = {"shape": f"a, b (24,{a.shape[-1]}) i32", "ms": [cuda_ms(run, 50) for _ in range(3)],
                      **card_time(run, FE_MUL_KERNELS, 50)}
    lib = ctypes.CDLL(str(kernels.build()["probes"]))
    if hasattr(lib, "fe_mul_bn254_g1_c_consts_launch"):
        launches = {"immediates": lib.fe_mul_bn254_g1_launch, "c_consts": lib.fe_mul_bn254_g1_c_consts_launch}
        for fn in launches.values():
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int

        def forced(form, mc, x, y, res):
            err = launches[form](mc.data_ptr(), x.data_ptr(), y.data_ptr(), res.data_ptr(), x.shape[-1],
                                 torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"fe_mul bn254_g1 {form} failed with CUDA error {err}")

        mc, a, b, _, _ = probes.mul_inputs(dev, "bn254_g1")
        E = a.shape[-1]
        cases = [(a, b)] + [probes.mul_inputs(dev, "bn254_g1", e, seed=e)[1:3] for e in (E - 100, 100)]
        for form in launches:
            for x, y in cases:
                res = torch.empty_like(x)
                forced(form, mc, x, y, res)
                torch.cuda.synchronize()
                _limbs_err(f"fe_mul bn254_g1 {form} at E {x.shape[-1]}", res,
                           kernels.fe_mul_plain(mc, x, y, curve="bn254_g1"))
        ablation: dict = {form: {"ms": [], "card_us": [], "dtod_us": []} for form in launches}
        res = torch.empty_like(a)
        for form in FE_MUL_ABLATION:
            run = lambda: forced(form, mc, a, b, res)  # noqa: E731
            ablation[form]["ms"].append(cuda_ms(run, 50))
            card = card_time(run, FE_MUL_KERNELS, 50)
            ablation[form]["card_us"].append(card["kernel_us"])
            ablation[form]["dtod_us"].append(card["dtod_us"])
        out["ablation"] = ablation
        out["sass"] = sass_counts("probes", FE_MUL_KERNELS)
    emit({"phase": "fe_mul", **out})


def _mont_consts(dev) -> dict:
    """The consts block of each field mont_mul runs in here."""
    from libzkp_tpu_torch.ops import ed25519 as ed
    from libzkp_tpu_torch.ops.field import BN254_FR
    from libzkp_tpu_torch.ops.limb import get_context

    out = {"BN254 Fr": get_context(BN254_FR.p, "bn254_fr").tensor("consts", dev),
           "2^255-19": get_context(ed.P).tensor("consts", dev)}
    try:
        from libzkp_tpu_torch.ops.field import F128
    except ImportError:  # a checkout from before the STARK slice
        return out
    return out | {"f128": get_context(F128.p).tensor("consts", dev)}


def _mont_cases(dev) -> list:
    """mont_mul's checked cases, (a, b, field, tag, shape): an NTT stage of
    a 256-statement h batch (3 * 256 polynomials of 512 points: 3 * 256 * 256
    butterflies, the stage's 256 twiddles broadcast; tag None: the kernels
    line's row), and of the membership path's (1024 points); a one-row operand (``to_mont`` of the whole batch, R^2
    broadcast: the Z^-1, R^2, 1 and R mod p case); the MiMC batch's 4096
    rows with b = a (x * x) and with one row (``to_mont``); ragged last
    blocks (M in {1, 127, 129}); b rows that are no contiguous run of a
    block (Mb = 3, and Mb = 129, whose run wraps to row 0); a and b from row
    1 of a tensor (bases not 16-byte aligned); P6's 2^20 rows in 2^255 - 19.
    Limbs in [-4096, 4096) or [0, 4096) (twiddles, constants). Where the
    tree has the n = 11 instance, f128 at the improvement batch's shapes
    (IMP_PAIRS traces, N = 64): the last stage of the forward NTT (tag
    "f128 LDE stage", the kernels line's mont_mul_n11 row), ``to_mont`` of
    the traces (one row), the coset shift (8 rows broadcast), rows at the
    canonicalisation's hazards (p - 1, p, 2p - 1, negated limbs, runs of
    0xFFF limbs, unreduced limbs) times random rows, ragged and odd row
    counts (1, 127, 129, 8191, 3 x 100 with Mb 3), and bases 44 bytes (one
    row) past an aligned one."""
    import numpy as np

    from libzkp_tpu_torch import probes
    from libzkp_tpu_torch.ops.field import BN254_FR
    from libzkp_tpu_torch.ops.limb import get_context
    from libzkp_tpu_torch.ops.ntt import _twiddle_table

    ctx = get_context(BN254_FR.p, "bn254_fr")
    n = ctx.n
    gen = np.random.default_rng(20261018)

    def rows(*shape, lo=-4096, limbs=n):
        return torch.from_numpy(gen.integers(lo, 4096, shape + (limbs,), dtype=np.int32)).to(dev)

    tw = torch.from_numpy(_twiddle_table(ctx.p, H_N, False)[-1]).to(dev)  # (256, n), the last stage
    stage = rows(3 * G16_LANES, H_N // 2)
    mimc = rows(MIMC_VALUES, lo=0)
    mem_tw = torch.from_numpy(_twiddle_table(ctx.p, MEM_H_N, False)[-1]).to(dev)
    cases = [(stage, tw, "BN254 Fr", None, f"a ({3 * G16_LANES},{H_N // 2},{n}) i32, b ({H_N // 2},{n}) broadcast"),
             (rows(3 * MEM_LANES, MEM_H_N // 2), mem_tw, "BN254 Fr", "membership NTT stage",
              f"a ({3 * MEM_LANES},{MEM_H_N // 2},{n}) i32, b ({MEM_H_N // 2},{n}) broadcast"),
             (rows(3 * G16_LANES, H_N, lo=0), ctx.tensor("r2", dev), "BN254 Fr", "one-row operand",
              f"a ({3 * G16_LANES},{H_N},{n}) i32, b ({n},)"),
             (mimc, mimc, "BN254 Fr", "MiMC x * x", f"a, b ({MIMC_VALUES},{n}) i32"),
             (mimc, ctx.tensor("r2", dev), "BN254 Fr", "MiMC to_mont", f"a ({MIMC_VALUES},{n}) i32, b ({n},)")]
    for M in (1, 127, 129):
        cases.append((rows(M), rows(M), "BN254 Fr", f"ragged M {M}", f"a, b ({M},{n}) i32"))
    for Mb, reps in ((3, 100), (129, 4)):
        cases.append((rows(reps, Mb), rows(Mb, lo=0), "BN254 Fr", f"Mb {Mb}",
                      f"a ({reps},{Mb},{n}) i32, b ({Mb},{n})"))
    a1, b1 = rows(1 + 4096), rows(1 + 4096)
    cases.append((a1[1:], b1[1:], "BN254 Fr", "bases not 16-byte aligned",
                  f"a, b ({4096},{n}) i32 from row 1"))
    _, pa, pb = probes.mont_mul_inputs(dev)
    cases.append((pa, pb, "2^255-19", "P6", f"a, b ({pa.shape[0]},{n}) i32"))
    if "f128" not in _mont_consts(dev):
        return cases
    from libzkp_tpu_torch.ops.field import F128
    from libzkp_tpu_torch.ops.ntt import _offset_powers

    fctx = get_context(F128.p)
    fn = fctx.n
    N = IMP_TRACE * IMP_BLOWUP
    f_tw = torch.from_numpy(_twiddle_table(F128.p, N, False)[-1]).to(dev)  # (32, 11)
    p_limbs = [(v >> (12 * i)) & 0xFFF for v in (F128.p - 1, F128.p, 2 * F128.p - 1, (1 << 128) - 1)
               for i in range(fn)]
    hazard = torch.tensor(p_limbs, dtype=torch.int32, device=dev).reshape(4, fn)
    hazard = torch.cat([hazard, -hazard, torch.full((1, fn), 4095, dtype=torch.int32, device=dev),
                        torch.full((1, fn), -4096, dtype=torch.int32, device=dev),
                        torch.full((1, fn), 8191, dtype=torch.int32, device=dev)])
    hz = hazard.repeat(64, 1)  # 704 rows
    cases += [
        (rows(IMP_PAIRS, N // 2, limbs=fn), f_tw, "f128", "f128 LDE stage",
         f"a ({IMP_PAIRS},{N // 2},{fn}) i32, b ({N // 2},{fn}) broadcast"),
        (rows(IMP_PAIRS, IMP_TRACE, lo=0, limbs=fn), fctx.tensor("r2", dev), "f128", "f128 to_mont",
         f"a ({IMP_PAIRS},{IMP_TRACE},{fn}) i32, b ({fn},)"),
        (rows(IMP_PAIRS, IMP_TRACE, limbs=fn), _offset_powers(F128.p, IMP_TRACE, 3, dev), "f128",
         "f128 coset shift", f"a ({IMP_PAIRS},{IMP_TRACE},{fn}) i32, b ({IMP_TRACE},{fn}) broadcast"),
        (hz, rows(hz.shape[0], limbs=fn), "f128", "f128 near p",
         f"a ({hz.shape[0]},{fn}) i32 at p - 1, p, 2p - 1, 2^128 - 1, their negations, 0xFFF, -4096, 8191"),
        (hz, hz.flip(0).contiguous(), "f128", "f128 near p squared", f"a, b ({hz.shape[0]},{fn}) i32"),
    ]
    for M in (1, 127, 129, 8191):
        cases.append((rows(M, limbs=fn), rows(M, limbs=fn), "f128", f"f128 ragged M {M}",
                      f"a, b ({M},{fn}) i32"))
    cases.append((rows(100, 3, limbs=fn), rows(3, lo=0, limbs=fn), "f128", "f128 Mb 3",
                  f"a (100,3,{fn}) i32, b (3,{fn})"))
    fa, fb = rows(1 + 8192, limbs=fn), rows(1 + 8192, limbs=fn)
    cases.append((fa[1:], fb[1:], "f128", "f128 bases not 8-byte aligned", f"a, b (8192,{fn}) i32 from row 1"))
    return cases


def _mont_instance(kernels, a) -> str:
    """The mont_mul instance ``a``'s limb count runs (mont_mul on a tree
    with one instance)."""
    ns = getattr(kernels, "MONT_NS", {22: None})
    return kernels.instance("mont_mul", ns[a.shape[-1]])


def check_mont_kernels(dev, int_rate: float) -> list:
    """Phase 3e: mont_mul against its plain version, limb for limb, at
    :func:`_mont_cases` (every case emitted; the kernels line keeps the
    paths' shapes: the BN254 NTT stage's row for mont_mul, the f128 LDE
    stage's for mont_mul_n11); the cases of MONT_TIMED timed, with the
    card's time a launch from the profiler."""
    from libzkp_tpu_torch.ops import kernels

    consts = _mont_consts(dev)
    results = []
    for a, b, field, tag, shape in _mont_cases(dev):
        c = consts[field]
        n = c.shape[1]
        out_k = kernels.mont_mul(c, a, b)
        out_p = kernels.mont_mul_plain(c, a, b)
        torch.cuda.synchronize()
        err = _limbs_err(f"mont_mul ({field}, {shape})", out_k, out_p)
        M, Mb = a.numel() // n, b.numel() // n
        b_ms, b_by = bound((2 * n * n + n) * M, (2 * M + Mb) * n * 4, int_rate)
        row = dict(name=_mont_instance(kernels, a), route="cuda", source="libzkp_tpu_torch/csrc/mont.cu",
                   replaces="scripts/bench_pallas_mul.py:96", max_abs_err=float(err),
                   tolerance="exact limbs", bound_ms=b_ms, bound_by=b_by, library_ms=None, shape=shape,
                   field=field)
        if tag in MONT_TIMED:
            row |= dict(ms=cuda_ms(lambda: kernels.mont_mul(c, a, b), 20),
                        plain_ms=cuda_ms(lambda: kernels.mont_mul_plain(c, a, b), 2),
                        card=card_time(lambda: kernels.mont_mul(c, a, b), ("mont_mul_kernel",), 20))
        emit({"phase": "kernel_check", **row, **({"probe": tag} if tag == "P6" else
                                                 {"case": tag} if tag else {})})
        if tag in (None, "f128 LDE stage"):
            results.append(row)
    return results


def check_blake3_kernel(dev, int_rate: float) -> list:
    """Phase 3g: blake3 against its plain version (``compress_vec``), word
    for word, at the improvement batch's B3_ROWS leaves of 16 bytes (the
    kernels line) and at a level of B3_ROWS / 2 64-byte blocks, both timed
    with CUDA events and the card's time a launch from the profiler; and at
    B3_RAGGED's lane counts, message lengths and flags."""
    from libzkp_tpu_torch.ops import kernels
    from libzkp_tpu_torch.ops.blake3_device import STANDALONE

    gen = torch.Generator().manual_seed(2222)

    def words(lanes, block_len):
        m = torch.randint(0, 1 << 32, (lanes, 16), generator=gen, dtype=torch.int64)
        m[:, (block_len + 3) // 4:] = 0  # the zero-padded block
        return m.to(dev)

    results = []
    for lanes, block_len in ((B3_ROWS, B3_ROW_BYTES), (B3_ROWS // 2, 64)):
        m = words(lanes, block_len)
        out_k = kernels.blake3(m, block_len, STANDALONE)
        out_p = kernels.blake3_plain(m, block_len, STANDALONE)
        torch.cuda.synchronize()
        err = _limbs_err(f"blake3 ({lanes} lanes, block_len {block_len})", out_k, out_p)
        b_ms, b_by = bound(B3_OPS * lanes, B3_LANE_BYTES * lanes, int_rate)
        row = dict(name="blake3", route="cuda", source="libzkp_tpu_torch/csrc/blake3.cu",
                   replaces="libzkp_tpu/ops/blake3_device.py:94", max_abs_err=float(err),
                   tolerance="exact words", ms=cuda_ms(lambda: kernels.blake3(m, block_len, STANDALONE), 50),
                   plain_ms=cuda_ms(lambda: kernels.blake3_plain(m, block_len, STANDALONE), 3),
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   shape=f"m ({lanes}, 16) i64, block_len {block_len}",
                   card=card_time(lambda: kernels.blake3(m, block_len, STANDALONE), ("blake3_kernel",), 20))
        emit({"phase": "kernel_check", **row})
        if block_len == B3_ROW_BYTES:
            results.append(row)
    for lanes, block_len, flags in B3_RAGGED:
        m = words(lanes, block_len)
        _limbs_err(f"blake3 ({lanes} lanes, block_len {block_len}, flags {flags})",
                   kernels.blake3(m, block_len, flags), kernels.blake3_plain(m, block_len, flags))
    emit({"phase": "kernel_check", "name": "blake3", "ragged": True, "cases": [list(c) for c in B3_RAGGED],
          "identical": True})
    return results


def mont_pair(dev) -> None:
    """mont_mul alone through its wrapper at the NTT stage, MiMC's two
    shapes, P6's and (where the tree has it) the f128 LDE stage, each limb
    for limb against its plain version, timed (CUDA events) with the card's
    time a launch (profiler); where the tree has ``MONT_ROWS`` (a block of
    rows staged in shared memory), also at 32, 64, 128 and 256 rows a block,
    each timed in turns, with the card's time a launch; runs on an earlier
    checkout too (this script copied into it), for timings paired in one
    call. One mont_pair line."""
    from libzkp_tpu_torch.ops import kernels

    consts = _mont_consts(dev)
    out: dict = {"card": smi("name,power.limit")}
    for a, b, field, tag, shape in _mont_cases(dev):
        if tag not in MONT_TIMED or tag in ("one-row operand", "f128 to_mont"):
            continue
        c = consts[field]
        n = c.shape[1]
        _limbs_err(f"mont_mul ({shape})", kernels.mont_mul(c, a, b), kernels.mont_mul_plain(c, a, b))
        row = {"shape": shape, "ms": cuda_ms(lambda: kernels.mont_mul(c, a, b), 20),
               **card_time(lambda: kernels.mont_mul(c, a, b), ("mont_mul_kernel",), 20)}
        M, Mb = a.numel() // n, b.numel() // n
        if hasattr(kernels, "MONT_ROWS") and tag != "P6":
            res = torch.empty_like(a)
            variant = getattr(kernels, "MONT_NS", {22: None})[n]

            def forced(R):
                kernels._run("mont_mul", variant, dev, c.data_ptr(), a.data_ptr(), b.data_ptr(),
                             res.data_ptr(), n, M, Mb, R)

            want = kernels.mont_mul_plain(c, a, b)
            sweep, card = {}, {}
            for R in (32, 64, 128, 256, 256, 128, 64, 32):
                forced(R)
                torch.cuda.synchronize()
                _limbs_err(f"mont_mul at {R} rows a block ({shape})", res, want)
                sweep.setdefault(R, []).append(cuda_ms(lambda: forced(R), 20))
                card.setdefault(R, []).append(card_time(lambda: forced(R), ("mont_mul_kernel",), 20)["kernel_us"])
            row |= {"rows": kernels.MONT_ROWS, "ms_by_rows": sweep, "card_us_by_rows": card}
        out[tag or "ntt_stage"] = row
    emit({"phase": "mont_pair", **out})


def ed_table(dev) -> tuple:
    """Consts and a relaxed (KP * 256, 4, n) int16 multiples table of KP
    random ed25519 points, built with the plain table-add chain (kernel
    launches here would not be the path's)."""
    import numpy as np

    from libzkp_tpu_torch.ops import curve, ed25519 as ed, kernels

    eng = curve.edwards_engine()
    rng = random.Random(20261016)
    consts = torch.from_numpy(eng.consts_np).to(dev)
    pts = [ed.from_uniform_bytes(rng.randbytes(64)) for _ in range(KP)]
    baseT = torch.from_numpy(np.ascontiguousarray(np.transpose(eng.encode_points(pts), (1, 2, 0)))).to(dev)
    acc = eng.identity(KP, dev)
    rows = [acc]
    for _ in range(255):
        acc = kernels.pair_add_plain(consts, acc, baseT)
        rows.append(acc)
    return consts, torch.stack(rows).permute(3, 0, 1, 2).reshape(KP * 256, eng.coords, eng.n).to(
        torch.int16).contiguous()


def ed_tree_pair(dev) -> None:
    """tree_sum ed25519 alone through its wrapper at the mesh block's shape
    (128 lanes, 96 points) and at RAGGED_TREE_SHAPES' B = 128 shapes, held
    by point equality against its plain version (limbs reported, not
    required: an earlier checkout summed in another order), timed (CUDA
    events) with the card's time a launch (profiler); runs on an earlier
    checkout too (this script copied into it). One ed_tree_pair line."""
    from libzkp_tpu_torch.ops import kernels

    curve = "ed25519"
    consts, table = ed_table(dev)
    C, n = table.shape[1:]
    out: dict = {"card": smi("name,power.limit")}
    for k in [SHARD_K_LOCAL[curve]] + [k for B, k in RAGGED_TREE_SHAPES[curve] if B == SHARD_B_LOCAL]:
        digits = torch.randint(0, 256, (SHARD_B_LOCAL, k), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(k)).to(dev)
        pts = table[digits.to(torch.int64) + torch.arange(k, device=dev) * 256].contiguous()
        got = kernels.tree_sum(consts, pts, curve=curve)
        want = kernels.tree_sum_plain(consts, pts, curve=curve)
        torch.cuda.synchronize()
        if _edwards_point_err(got, want) != 0:
            raise AssertionError(f"tree_sum {curve} at k {k} disagrees with its plain version")
        out[f"k{k}"] = {"shape": f"pts ({SHARD_B_LOCAL},{k},{C},{n}) i16",
                        "limbs_equal": bool(torch.equal(got, want)),
                        "ms": cuda_ms(lambda: kernels.tree_sum(consts, pts, curve=curve), 20),
                        **card_time(lambda: kernels.tree_sum(consts, pts, curve=curve),
                                    TREE_SUM_KERNELS[curve], 20)}
    emit({"phase": "ed_tree_pair", **out})


def ed_pair(dev) -> None:
    """K3 pair_add ed25519 alone through its wrapper: at the range table's
    K = 160 (rows 7 and 200 of each basis point's multiples), at
    RAGGED_PAIR_ADD's K and at P5's 2^18 lanes, each limb for limb against
    its plain version, timed (CUDA events) with the card's time a launch
    (profiler); the range basis's table build (255 launches) timed, wall
    and card; where the kernel is cooperative (this tree), K = 160 and P5
    also at ED_PAIR_WARPS warps a block, in turns, each limb for limb.
    Runs on an earlier checkout too (this script copied into it). One
    ed_pair line."""
    from libzkp_tpu_torch import probes
    from libzkp_tpu_torch.models import bp_device
    from libzkp_tpu_torch.ops import curve, kernels

    consts, table = ed_table(dev)
    C, n = table.shape[1:]
    rows = table.view(KP, 256, C, n)

    def lanes(K, row):  # basis point k % KP's multiple `row`, (C, n, K) int32
        return rows[torch.arange(K, device=dev) % KP, row].permute(1, 2, 0).to(torch.int32).contiguous()

    _, pp, pq, _, _ = probes.add_inputs(dev)
    shapes = {KP: (lanes(KP, 7), lanes(KP, 200)), "P5": (pp, pq)}
    ragged = RAGGED_PAIR_ADD["ed25519"][0]
    shapes |= {K: (lanes(K, 3 + K % 200), lanes(K, 250 - K % 200)) for K in ragged}
    out: dict = {"card": smi("name,power.limit")}
    for key, (p, q) in shapes.items():
        want = kernels.pair_add_plain(consts, p, q)
        _limbs_err(f"pair_add ed25519 at K {p.shape[-1]}", kernels.pair_add(consts, p, q), want)
        if key in (KP, "P5"):
            out[f"K{p.shape[-1]}"] = {"ms": cuda_ms(lambda: kernels.pair_add(consts, p, q), 50),
                                      **card_time(lambda: kernels.pair_add(consts, p, q), PAIR_ADD_ED_KERNELS, 20)}
    out["ragged_limbs_equal"] = list(ragged)

    base = curve.edwards_engine().encode_points(bp_device._basis_points(64))
    build = lambda: curve.DeviceTable(base, device=dev)  # noqa: E731
    build_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        build()
        torch.cuda.synchronize()
        build_ms.append((time.perf_counter() - t0) * 1e3)
    out["table_build"] = {"wall_ms": build_ms, **card_time(build, PAIR_ADD_ED_KERNELS, 1)}

    if len(kernels._ARGTYPES["pair_add"]) > 6:  # cooperative: blocks, warps and shared bytes
        sweep: dict = {}
        for key in (KP, "P5"):
            p, q = shapes[key]
            K = p.shape[-1]
            res, want = torch.empty_like(p), kernels.pair_add_plain(consts, p, q)
            per_warp = kernels.COOP_PADDS_PER_WARP["ed25519"]

            def forced(w):  # per group: p and q as int16 points and the padd's scratch
                smem = w * per_warp * (2 * kernels.POINT_BYTES["ed25519"] + kernels.COOP_SCRATCH_BYTES["ed25519"])
                kernels._run("pair_add", "ed25519", dev, consts.data_ptr(), p.data_ptr(), q.data_ptr(),
                             res.data_ptr(), K, -(-K // (per_warp * w)), w, smem)

            for w in ED_PAIR_WARPS:
                forced(w)
                torch.cuda.synchronize()
                _limbs_err(f"pair_add ed25519 at K {K}, {w} warps a block", res, want)
                cell = sweep.setdefault(f"K{K}", {}).setdefault(w, {"ms": [], "card_us": []})
                cell["ms"].append(cuda_ms(lambda: forced(w), 50))
                cell["card_us"].append(card_time(lambda: forced(w), PAIR_ADD_ED_KERNELS, 20)["kernel_us"])
        out["warps"] = sweep
    emit({"phase": "ed_pair", **out})


def f32_chain(dev) -> None:
    """P3 padd_f32_chain alone through its wrapper at its probe's shape (64
    chained additions over 512 lanes), limb for limb against its plain
    version, its largest limb within F32_HALF + 32, timed (CUDA events) with
    the card's time a launch (profiler). Runs on an earlier checkout too.
    One f32_chain line."""
    from libzkp_tpu_torch import probes
    from libzkp_tpu_torch.ops import kernels

    R = probes.CHAIN_R
    fc, fp, fq, _, _ = probes.f32_chain_inputs(dev)
    got = kernels.padd_f32_chain(fc, fp, fq, R)
    want = kernels.padd_f32_chain_plain(fc, fp, fq, R)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    top = float(got.abs().max())
    if err != 0 or top > probes.F32_HALF + 32:
        raise AssertionError(f"padd_f32_chain: limbs differ by {err}, largest limb {top}")
    run = lambda: kernels.padd_f32_chain(fc, fp, fq, R)  # noqa: E731
    emit({"phase": "f32_chain", "card": smi("name,power.limit"), "shape": f"p, q (4,29,{fp.shape[-1]}) f32, chain {R}",
          "max_abs_err": err, "max_abs_limb": top, "ms": [cuda_ms(run, 10) for _ in range(3)],
          **card_time(run, F32_CHAIN_KERNELS, 10)})


def ed_chain(dev) -> None:
    """P2 padd_chain alone through its wrapper at its probe's shape (64
    chained additions over 512 lanes), limb for limb against its plain
    version, timed (CUDA events) with the card's time a launch (profiler);
    where the chain is cooperative (this tree), also at ED_CHAIN_WARPS warps
    a block (the wrapper's CHAIN_WARPS among them), in turns, each limb for
    limb. Runs on an earlier checkout too.
    One ed_chain line."""
    from libzkp_tpu_torch import probes
    from libzkp_tpu_torch.ops import kernels

    R = probes.CHAIN_R
    consts, p, q, _, _ = probes.chain_inputs(dev)
    B = p.shape[-1]
    want = kernels.padd_chain_plain(consts, p, q, R)
    _limbs_err("padd_chain", kernels.padd_chain(consts, p, q, R), want)
    run = lambda: kernels.padd_chain(consts, p, q, R)  # noqa: E731
    out: dict = {"card": smi("name,power.limit"), "shape": f"p, q (4,24,{B}) i32, chain {R}",
                 "ms": [cuda_ms(run, 20) for _ in range(3)], **card_time(run, CHAIN_KERNELS, 20)}
    if len(kernels._ARGTYPES["padd_chain"]) > 7:  # cooperative: blocks, warps and shared bytes
        res = torch.empty_like(p)
        per_warp = kernels.COOP_PADDS_PER_WARP["ed25519"]
        group = 2 * kernels.POINT_BYTES["ed25519"] + kernels.COOP_SCRATCH_BYTES["ed25519"]

        def forced(w):  # per group: the accumulator and q as int16 points and the padd's scratch
            kernels._run("padd_chain", "ed25519", dev, consts.data_ptr(), p.data_ptr(), q.data_ptr(),
                         res.data_ptr(), R, B, -(-B // (per_warp * w)), w, w * per_warp * group)

        sweep: dict = {}
        for w in ED_CHAIN_WARPS:
            forced(w)
            torch.cuda.synchronize()
            _limbs_err(f"padd_chain at {w} warps a block", res, want)
            cell = sweep.setdefault(w, {"ms": [], "card_us": []})
            cell["ms"].append(cuda_ms(lambda: forced(w), 20))
            cell["card_us"].append(card_time(lambda: forced(w), CHAIN_KERNELS, 20)["kernel_us"])
        out["warps"] = sweep
    emit({"phase": "ed_chain", **out})


def mont_padd_pair(dev) -> None:
    """P7 mont_padd alone through its wrapper at its probe's shape (2^18
    lanes), limb for limb against its plain version, timed (CUDA events)
    with the card's time a launch (profiler); where the kernel takes its
    block size (this tree), also at MONT_PADD_SWEEP lanes a block, in
    turns, each limb for limb. Runs on an earlier checkout too. One
    mont_padd line."""
    from libzkp_tpu_torch import probes
    from libzkp_tpu_torch.ops import kernels

    mc, mp, mq, _, _ = probes.mont_padd_inputs(dev)
    E = mp.shape[-1]
    want = kernels.mont_padd_plain(mc, mp, mq)
    _limbs_err("mont_padd", kernels.mont_padd(mc, mp, mq), want)
    run = lambda: kernels.mont_padd(mc, mp, mq)  # noqa: E731
    out: dict = {"card": smi("name,power.limit"), "shape": f"p, q (4,22,{E}) i32",
                 "ms": [cuda_ms(run, 20) for _ in range(3)], **card_time(run, MONT_PADD_KERNELS, 20)}
    if len(kernels._ARGTYPES["mont_padd"]) > 6:  # + lanes a block
        res = torch.empty_like(mp)

        def forced(threads):
            kernels._run("mont_padd", None, dev, mc.data_ptr(), mp.data_ptr(), mq.data_ptr(), res.data_ptr(),
                         E, threads)

        sweep: dict = {}
        for threads in MONT_PADD_SWEEP:
            forced(threads)
            torch.cuda.synchronize()
            _limbs_err(f"mont_padd at {threads} lanes a block", res, want)
            cell = sweep.setdefault(threads, {"ms": [], "card_us": []})
            cell["ms"].append(cuda_ms(lambda: forced(threads), 20))
            cell["card_us"].append(card_time(lambda: forced(threads), MONT_PADD_KERNELS, 20)["kernel_us"])
        out |= {"threads": kernels.MONT_PADD_THREADS, "by_threads": sweep}
    emit({"phase": "mont_padd", **out})


def equality_pairs() -> list:
    """Phase 5's G16_LANES distinct equality statements (v, v)."""
    rng = random.Random(1017)
    values = [(1 << 64) - 1, 0] + rng.sample(range(1, 1 << 62), G16_LANES - 2)
    return [(v, v) for v in values]


def groth16_path(dev) -> dict:
    """Phase 5: 256 distinct equality proofs through the port's entry point."""
    import libzkp_tpu_torch as zkp
    from libzkp_tpu_torch.models import groth16, snark_backend
    from libzkp_tpu_torch.ops import kernels
    from libzkp_tpu_torch.utils.commitment import commit_value_snark
    from libzkp_tpu_torch.utils.envelope import Proof as Envelope

    t0 = time.perf_counter()
    pk = snark_backend._get_equality_setup()
    emit({"phase": "groth16_setup", "seconds": time.perf_counter() - t0,
          "queries": {"a": len(pk.a_query), "b_g1": len(pk.b_g1_query), "b_g2": len(pk.b_g2_query),
                      "h": len(pk.h_query), "l": len(pk.l_query)}})

    pairs = equality_pairs()
    values = [v for v, _ in pairs]

    kernels.reset_launches()
    t0 = time.perf_counter()
    envs = zkp.prove_equality_batch(pairs, device=dev)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = kernels.launches()
    want = dict.fromkeys(kernels.INSTANCES, 0) | {
        "pair_add_bn254_g1": 4 * 255, "pair_add_bn254_g2": 255,
        "window_sum4_bn254_g1": 4 * 8, "window_sum4_bn254_g2": 8,
        "horner4_bn254_g1": 4 * 8, "horner4_bn254_g2": 8, "mont_mul": H_MONT_MULS,
    }
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the Groth16 path needs {want}")
    if len(envs) != G16_LANES or any(not isinstance(e, bytes) or len(e) < 256 for e in envs):
        raise AssertionError("prove_equality_batch returned malformed envelopes")
    emit({"phase": "groth16_cold", "equality_proofs": G16_LANES, "seconds": cold_s,
          "launches": {k: v for k, v in counts.items() if v}})

    batch_s = []
    for _ in range(TIMED_BATCHES):
        t0 = time.perf_counter()
        zkp.prove_equality_batch(pairs, device=dev)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    batch_ms = sum(batch_s) / len(batch_s) * 1e3  # mean over every uninstrumented warm batch
    emit({"phase": "groth16_warm", "batch_ms": [s * 1e3 for s in batch_s], "ms_per_batch": batch_ms,
          "spread_ms": [min(batch_s) * 1e3, max(batch_s) * 1e3],
          "ms_per_equality_proof": batch_ms / G16_LANES})

    # the split: h (host sparse products, then the device NTTs with their
    # encode and decode), device query MSMs (with their host digit and
    # decode glue), host finish; the rest is commitments, assignments and
    # proof bytes
    spent: dict = defaultdict(float)
    depth = [0]
    undo = [_wrap(groth16, name, name, spent, depth)
            for name in ("_h_many", "_accs_many", "_finish_proof")]
    try:
        t0 = time.perf_counter()
        zkp.prove_equality_batch(pairs, device=dev)
        torch.cuda.synchronize()
        split_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for u in undo:
            u()
    split = {"h_ms": spent["_h_many"] * 1e3, "device_query_msms_ms": spent["_accs_many"] * 1e3,
             "host_finish_ms": spent["_finish_proof"] * 1e3}
    split["host_assign_rest_ms"] = split_ms - sum(split.values())
    emit({"phase": "groth16_split", "batch_ms": split_ms, **split})

    # one batch under the profiler, with injected randomness for the
    # byte-exact check below
    seeded = random.Random(4242)
    draws = [seeded.randrange(1, groth16.R) for _ in range(2 * G16_LANES)]
    saved = groth16._rand_fr
    it = iter(draws)
    groth16._rand_fr = lambda: next(it)
    try:
        seeded_envs, prof_ms, busy = profiled(lambda: zkp.prove_equality_batch(pairs, device=dev))
    finally:
        groth16._rand_fr = saved
    emit({"phase": "groth16_profile", "batch_ms_profiled": prof_ms,
          **busy_summary(busy, prof_ms, mont_mul="mont_mul_kernel", window_sum4_g1=WS4_G1_KERNELS)})

    sample = list(range(0, G16_LANES, G16_LANES // G16_VERIFY))[:G16_VERIFY]
    t0 = time.perf_counter()
    for i in sample:
        if not zkp.verify_equality(envs[i], values[i], values[i]):
            raise AssertionError(f"equality proof {i} does not verify")
    bad = bytearray(envs[sample[1]])
    bad[len(bad) // 2] ^= 1
    if zkp.verify_equality(bytes(bad), values[sample[1]], values[sample[1]]):
        raise AssertionError("a tampered equality proof verified")
    emit({"phase": "groth16_verify_sample", "verified": len(sample), "tamper_rejected": True,
          "seconds": time.perf_counter() - t0})

    # byte-exactness: 2 lanes of the seeded device batch against the host
    # golden prover (host h, host MSMs, host finish) with the same (r, s)
    lanes = [1, G16_LANES - 1]
    for lane in lanes:
        v = values[lane]
        c = commit_value_snark(v)
        cs = snark_backend.build_equality_circuit(v, v, int.from_bytes(c, "little"))
        it = iter(draws[2 * lane : 2 * lane + 2])
        groth16._rand_fr = lambda: next(it)
        try:
            proof = groth16.proof_to_bytes(groth16.prove(pk, cs))
        finally:
            groth16._rand_fr = saved
        if Envelope.from_bytes(seeded_envs[lane]).proof != proof:
            raise AssertionError(f"lane {lane}: device batch proof differs from the host golden prover")
    emit({"phase": "groth16_byte_exact", "lanes": lanes, "proof_bytes": 256, "identical": True})
    return {"counts": counts, "ms_per_batch": batch_ms, "split": split, "pairs": pairs,
            "draws": draws, "seeded_envs": seeded_envs}


def groth16_grouped(dev) -> dict:
    """Phase 6: 256 equality proofs of 8 statements, 32 proofs each, so
    every statement takes the grouped finish (``_finish_proof_group``: its
    per-proof terms as fixed-basis MSMs on the card), against the per-proof
    finish (``_finish_proof`` on the host) on the same batch and the same
    injected (r, s) draws. The per-proof route is forced by raising
    ``groth16.GROUP_MIN`` above the group size for the call."""
    import libzkp_tpu_torch as zkp
    from libzkp_tpu_torch.models import groth16, snark_backend
    from libzkp_tpu_torch.ops import kernels
    from libzkp_tpu_torch.utils.commitment import commit_value_snark
    from libzkp_tpu_torch.utils.envelope import Proof as Envelope

    S = G16_GROUP_STATEMENTS
    per = G16_LANES // S
    rng = random.Random(1018)
    values = rng.sample(range(1, 1 << 62), S)
    pairs = [(values[i % S], values[i % S]) for i in range(G16_LANES)]
    seeded = random.Random(4343)
    draws = [seeded.randrange(1, groth16.R) for _ in range(2 * G16_LANES)]

    def run(grouped: bool, wrap=()):
        saved = groth16._rand_fr, groth16.GROUP_MIN
        it = iter(draws)
        groth16._rand_fr = lambda: next(it)
        groth16.GROUP_MIN = saved[1] if grouped else G16_LANES + 1
        spent: dict = defaultdict(float)
        undo = [_wrap(groth16, name, name, spent, [0]) for name in wrap]
        try:
            t0 = time.perf_counter()
            envs = zkp.prove_equality_batch(pairs, device=dev)
            torch.cuda.synchronize()
            return envs, (time.perf_counter() - t0) * 1e3, {k: v * 1e3 for k, v in spent.items()}
        finally:
            for u in undo:
                u()
            groth16._rand_fr, groth16.GROUP_MIN = saved

    # the grouped route's launches on its first batch: h of the 8
    # statements; the five query MSMs at 8 lanes (8 window groups each);
    # the key's [delta_g1] and
    # [delta_g2] tables, built once; per statement, its own
    # [P1, P2, delta_g1] table and three 32-lane MSMs
    kernels.reset_launches()
    envs, cold_ms, _ = run(True)
    counts = kernels.launches()
    want = dict.fromkeys(kernels.INSTANCES, 0) | {
        "pair_add_bn254_g1": 255 + S * 255, "pair_add_bn254_g2": 255,
        "window_sum4_bn254_g1": 4 * 8 + S * 2 * 8, "window_sum4_bn254_g2": 8 + S * 8,
        "horner4_bn254_g1": 4 * 8 + S * 2 * 8, "horner4_bn254_g2": 8 + S * 8,
        "mont_mul": H_MONT_MULS,
    }
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the grouped route needs {want}")
    emit({"phase": "groth16_grouped_cold", "equality_proofs": G16_LANES, "statements": S,
          "batch_ms": cold_ms, "launches": {k: v for k, v in counts.items() if v}})

    # parent, change, change, parent: the per-proof and grouped routes
    # interleaved, every run under the same draws, so every run's bytes
    # must equal the first's
    times: dict = {"per_proof": [], "grouped": []}
    for grouped in (False, True, True, False):
        out, ms, _ = run(grouped)
        if out != envs:
            raise AssertionError(f"{'grouped' if grouped else 'per-proof'} route gave other proof bytes")
        times["grouped" if grouped else "per_proof"].append(ms)
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    out, split_ms, spent = run(True, wrap=("_h_many", "_accs_many", "_finish_proof_group"))
    if out != envs:
        raise AssertionError("the grouped split run gave other proof bytes")
    # one grouped batch under the profiler: the card's time in pair_add G1
    # (the statement tables' 255-step builds) and the builds' wall time
    from libzkp_tpu_torch.ops import curve as tc

    built: dict = defaultdict(float)
    undo = _wrap(tc.DeviceTable, "__init__", "table_builds", built, [0])
    try:
        (out, _, _), prof_ms, busy = profiled(lambda: run(True))
    finally:
        undo()
    if out != envs:
        raise AssertionError("the profiled grouped run gave other proof bytes")
    emit({"phase": "groth16_grouped_profile", "batch_ms_profiled": prof_ms,
          "table_builds_ms": built["table_builds"] * 1e3,
          **busy_summary(busy, prof_ms, pair_add_g1=PAIR_ADD_G1_KERNELS, window_sum4_g1=WS4_G1_KERNELS)})
    emit({"phase": "groth16_grouped_vs_per_proof", "batch_ms": times,
          "ms_per_equality_proof": {k: v / G16_LANES for k, v in mean.items()},
          "per_proof_over_grouped": mean["per_proof"] / mean["grouped"],
          "grouped_split": {"batch_ms": split_ms, "h_ms": spent["_h_many"],
                            "device_query_msms_ms": spent["_accs_many"],
                            "finish_group_ms": spent["_finish_proof_group"]}})

    # byte-exactness against the host golden prover: proof m of statement k
    # drew (r, s) = draws[2 * (per * k + m) : + 2] on both routes
    pk = snark_backend._get_equality_setup()
    lanes = [3, G16_LANES - 6]
    saved = groth16._rand_fr
    for lane in lanes:
        k, m = lane % S, lane // S
        v = values[k]
        cs = snark_backend.build_equality_circuit(v, v, int.from_bytes(commit_value_snark(v), "little"))
        it = iter(draws[2 * (per * k + m) : 2 * (per * k + m) + 2])
        groth16._rand_fr = lambda: next(it)
        try:
            proof = groth16.proof_to_bytes(groth16.prove(pk, cs))
        finally:
            groth16._rand_fr = saved
        if Envelope.from_bytes(envs[lane]).proof != proof:
            raise AssertionError(f"lane {lane}: grouped proof differs from the host golden prover")
    for i in (0, G16_LANES - 1):
        if not zkp.verify_equality(envs[i], pairs[i][0], pairs[i][1]):
            raise AssertionError(f"grouped equality proof {i} does not verify")
    emit({"phase": "groth16_grouped_byte_exact", "lanes": lanes, "identical": True,
          "runs_identical": 7, "verified": 2})
    return {"counts": counts, "ms_per_batch": mean}


def membership_items() -> list:
    """MEM_LANES distinct (value, set) statements, seeded: sets of 1 to 64
    values (a set of 1 and a set of 64 among them), each value drawn from
    its set."""
    rng = random.Random(1019)
    sizes = [1, 64] + [rng.randint(1, 64) for _ in range(MEM_LANES - 2)]
    items = []
    for size in sizes:
        the_set = rng.sample(range(1 << 62), size)
        items.append((rng.choice(the_set), the_set))
    return items


def _membership_entry(env: bytes, the_set: list) -> tuple:
    """(Groth16 proof bytes, set, commitment) of a membership envelope."""
    from libzkp_tpu_torch.utils.envelope import Proof as Envelope

    e = Envelope.from_bytes(env)
    return e.proof[4 + 8 * len(the_set):], the_set, e.commitment


def membership(dev) -> dict:
    """Phase 6b: MEM_LANES distinct set-membership proofs through the port's
    entry point, ``prove_membership_batch``. The cold batch's launches are
    asserted (its five query tables built, 255 pair_add launches each; per
    query MSM 8 window_sum4 and 8 horner4 launches; the h at n = 1024 in
    MEM_H_MONT_MULS mont_mul launches); warm batches timed; one split into
    h, device query MSMs and host finish; a seeded batch profiled (busy ms,
    idle share, the split); MEM_BYTE_LANES lanes held byte for byte against
    the native baseline ``prove_assigned_native`` and the golden ``prove``
    under the same draws; all proofs checked by ``verify_membership_batch``,
    with one forged proof (another proof's C) rejected, and two by
    ``verify_membership``. Runs under :func:`seam_tables_kept`, so the
    phases after it see the seam's LRU as it was."""
    import libzkp_tpu_torch as zkp
    from libzkp_tpu_torch.models import groth16, snark_backend
    from libzkp_tpu_torch.ops import kernels
    from libzkp_tpu_torch.utils.commitment import commit_value_snark

    t0 = time.perf_counter()
    pk = snark_backend._get_membership_setup()
    num_instance, csr = snark_backend._membership_shape()
    emit({"phase": "membership_setup", "seconds": time.perf_counter() - t0,
          "constraints": len(csr[0][0]) - 1, "instance": num_instance, "domain": len(pk.h_query) + 1,
          "queries": {"a": len(pk.a_query), "b_g1": len(pk.b_g1_query), "b_g2": len(pk.b_g2_query),
                      "h": len(pk.h_query), "l": len(pk.l_query)}})
    items = membership_items()
    sizes = [len(s) for _, s in items]

    kernels.reset_launches()
    t0 = time.perf_counter()
    envs = zkp.prove_membership_batch(items, device=dev)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = kernels.launches()
    want = dict.fromkeys(kernels.INSTANCES, 0) | {
        "pair_add_bn254_g1": 4 * 255, "pair_add_bn254_g2": 255,
        "window_sum4_bn254_g1": 4 * 8, "window_sum4_bn254_g2": 8,
        "horner4_bn254_g1": 4 * 8, "horner4_bn254_g2": 8, "mont_mul": MEM_H_MONT_MULS,
    }
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the membership path needs {want}")
    if len(envs) != MEM_LANES or any(not isinstance(e, bytes) or len(e) < 256 for e in envs):
        raise AssertionError("prove_membership_batch returned malformed envelopes")
    emit({"phase": "membership_cold", "membership_proofs": MEM_LANES, "seconds": cold_s,
          "set_sizes": [min(sizes), max(sizes)], "launches": {k: v for k, v in counts.items() if v}})

    batch_s = []
    for _ in range(TIMED_BATCHES):
        t0 = time.perf_counter()
        zkp.prove_membership_batch(items, device=dev)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    batch_ms = sum(batch_s) / len(batch_s) * 1e3
    emit({"phase": "membership_warm", "batch_ms": [x * 1e3 for x in batch_s], "ms_per_batch": batch_ms,
          "spread_ms": [min(batch_s) * 1e3, max(batch_s) * 1e3],
          "ms_per_membership_proof": batch_ms / MEM_LANES})

    def split_run(run):
        spent: dict = defaultdict(float)
        depth = [0]
        undo = [_wrap(groth16, name, name, spent, depth)
                for name in ("_h_many", "_accs_many", "_finish_proof")]
        try:
            out = run()
        finally:
            for u in undo:
                u()
        return out, {"h_ms": spent["_h_many"] * 1e3, "device_query_msms_ms": spent["_accs_many"] * 1e3,
                     "host_finish_ms": spent["_finish_proof"] * 1e3}

    t0 = time.perf_counter()
    _, split = split_run(lambda: zkp.prove_membership_batch(items, device=dev))
    split_ms = (time.perf_counter() - t0) * 1e3
    emit({"phase": "membership_split", "batch_ms": split_ms, **split,
          "host_assign_rest_ms": split_ms - sum(split.values())})

    seeded = random.Random(4545)
    draws = [seeded.randrange(1, groth16.R) for _ in range(2 * MEM_LANES)]
    saved = groth16._rand_fr
    it = iter(draws)
    groth16._rand_fr = lambda: next(it)
    try:
        (seeded_envs, prof_split), prof_ms, busy = profiled(
            lambda: split_run(lambda: zkp.prove_membership_batch(items, device=dev)))
    finally:
        groth16._rand_fr = saved
    emit({"phase": "membership_profile", "batch_ms_profiled": prof_ms, **prof_split,
          **busy_summary(busy, prof_ms, mont_mul="mont_mul_kernel", window_sum4_g1=WS4_G1_KERNELS,
                         window_sum4_g2="window_sum4_g2_kernel", horner4="coop_horner_kernel")})

    # byte-exactness: lanes of the seeded batch (a set of 1, a set of 64,
    # two more) against the native baseline and the host golden prover
    lanes = [0, 1, MEM_LANES // 2, MEM_LANES - 1]
    z_list = [snark_backend._membership_statement(v, s, commit_value_snark(v))
              for v, s in (items[i] for i in lanes)]
    it = iter([d for i in lanes for d in draws[2 * i : 2 * i + 2]])
    groth16._rand_fr = lambda: next(it)
    try:
        t0 = time.perf_counter()
        native_proofs = groth16.prove_assigned_native(pk, z_list, num_instance, csr)
        native_ms = (time.perf_counter() - t0) * 1e3
    finally:
        groth16._rand_fr = saved
    for lane, proof in zip(lanes, native_proofs):
        v, the_set = items[lane]
        if _membership_entry(seeded_envs[lane], the_set)[0] != groth16.proof_to_bytes(proof):
            raise AssertionError(f"lane {lane}: the card route's proof differs from prove_assigned_native's")
        pad = snark_backend.MAX_SET_SIZE - len(the_set)
        sel = [x == the_set.index(v) for x in range(snark_backend.MAX_SET_SIZE)]
        cs = snark_backend.build_membership_circuit(
            v, sel, the_set + [0] * pad, [True] * len(the_set) + [False] * pad,
            int.from_bytes(commit_value_snark(v), "little"))
        it = iter(draws[2 * lane : 2 * lane + 2])
        groth16._rand_fr = lambda: next(it)
        try:
            golden = groth16.proof_to_bytes(groth16.prove(pk, cs))
        finally:
            groth16._rand_fr = saved
        if golden != groth16.proof_to_bytes(proof):
            raise AssertionError(f"lane {lane}: the golden prover's proof differs")
    emit({"phase": "membership_byte_exact", "lanes": lanes, "set_sizes": [sizes[i] for i in lanes],
          "identical": True, "native_ms_for_the_lanes": native_ms})

    entries = [_membership_entry(e, s) for e, (_, s) in zip(envs, items)]
    t0 = time.perf_counter()
    verdicts = snark_backend.SnarkBackend.verify_membership_batch(entries)
    batch_verify_ms = (time.perf_counter() - t0) * 1e3
    if verdicts != [True] * MEM_LANES:
        raise AssertionError(f"verify_membership_batch: {verdicts.count(False)} of {MEM_LANES} proofs rejected")
    forged = MEM_LANES // 3
    bad = list(entries)
    proof = bytearray(bad[forged][0])
    proof[192:] = entries[forged + 1][0][192:]  # another proof's C: points on the curve, a wrong proof
    bad[forged] = (bytes(proof),) + bad[forged][1:]
    t0 = time.perf_counter()
    verdicts = snark_backend.SnarkBackend.verify_membership_batch(bad)
    bisect_ms = (time.perf_counter() - t0) * 1e3
    if verdicts != [i != forged for i in range(MEM_LANES)]:
        raise AssertionError("verify_membership_batch did not single out the forged proof")
    v, the_set = items[1]
    if not (zkp.verify_membership(envs[1], the_set) and zkp.verify_membership(envs[1], the_set[::-1])):
        raise AssertionError("verify_membership rejected a proof")
    if zkp.verify_membership(envs[1], the_set[:-1] + [the_set[-1] ^ 1]):
        raise AssertionError("verify_membership accepted a changed set")
    emit({"phase": "membership_verify", "proofs": MEM_LANES, "batch_ms": batch_verify_ms,
          "batch_ms_per_proof": batch_verify_ms / MEM_LANES, "forged_index": forged,
          "bisect_ms": bisect_ms, "forged_rejected": True})
    return {"counts": counts, "items": items, "envs": envs, "ms_per_batch": batch_ms, "split": split}


def improvement_pairs() -> list:
    """IMP_PAIRS distinct seeded (old, new) u64 pairs: (0, 2^64 - 1),
    adjacent values at 0, at 2^63 and at the top, (1, 8) and (30, 50), the
    rest random."""
    top = (1 << 64) - 1
    pairs = [(0, top), (0, 1), (1 << 63, (1 << 63) + 1), (top - 1, top), (1, 8), (30, 50)]
    rng = random.Random(5555)
    while len(pairs) < IMP_PAIRS:
        old, new = sorted(rng.randrange(1 << 64) for _ in range(2))
        if old < new and (old, new) not in pairs:
            pairs.append((old, new))
    return pairs


def improvement_native_hooks(pairs: list) -> dict:
    """The STARK's native hooks against their pure-Python goldens on this
    machine's host, µs a call both ways, every result equal: the NTT over
    f128 at n = 8 and 64 and over BN254 Fr at 512, BLAKE3 of the coin's
    48-byte draws, ``blake3_batch`` of a trace's 64 leaf messages of 16
    bytes and ``blake3_merkle_levels`` over its 64 leaf digests."""
    from libzkp_tpu_torch import native
    from libzkp_tpu_torch.ops import blake3, ntt
    from libzkp_tpu_torch.ops.field import BN254_FR, F128

    rng = random.Random(6464)
    out: dict = {}
    for F, n, count in ((F128, 8, 256), (F128, 64, 64), (BN254_FR, 512, 8)):
        inputs = [(F, [rng.randrange(F.p) for _ in range(n)]) for _ in range(count)]
        us, got = _per_call_us(ntt.ntt, inputs)
        us_py, want = _per_call_us(ntt.ntt_py, inputs)
        if got != want:
            raise AssertionError(f"native ntt differs from ntt_py at {F.name} n = {n}")
        out[f"ntt_{F.name}_{n}"] = {"native_us": us, "py_us": us_py}
    draws = [(rng.randbytes(48),) for _ in range(1024)]
    us, got = _per_call_us(blake3.blake3_256, draws)
    us_py, want = _per_call_us(blake3.blake3_256_py, draws)
    if got != want:
        raise AssertionError("native blake3_256 differs from blake3_256_py")
    out["blake3_256_48B"] = {"native_us": us, "py_us": us_py}
    rows = [[rng.randbytes(16) for _ in range(IMP_TRACE * IMP_BLOWUP)] for _ in range(64)]
    us, got = _per_call_us(lambda r: native.blake3_batch(r, 16), [(r,) for r in rows])
    us_py, want = _per_call_us(lambda r: [blake3.blake3_256_py(x) for x in r], [(r,) for r in rows])
    if got != want:
        raise AssertionError("native blake3_batch differs from blake3_256_py")
    out["blake3_batch_64x16B"] = {"native_us": us, "py_us": us_py}

    def levels_py(leaves):
        cur, levels = leaves, []
        while len(cur) > 1:
            cur = [blake3.merge_digests_py(cur[i], cur[i + 1]) for i in range(0, len(cur), 2)]
            levels.append(cur)
        return levels

    us, got = _per_call_us(native.blake3_merkle_levels, [(g,) for g in got])
    us_py, want = _per_call_us(levels_py, [(g,) for g in want])
    if got != want:
        raise AssertionError("native blake3_merkle_levels differs from merge_digests_py's")
    out["blake3_merkle_levels_64"] = {"native_us": us, "py_us": us_py}
    emit({"phase": "improvement_native_hooks", "card": smi("name,power.limit"), **out})
    return out


def improvement(dev) -> dict:
    """Phase 6c: IMP_PAIRS distinct improvement proofs (scheme 5) through the
    port's entry point, ``prove_improvement_batch``, the card route: every
    trace's coset LDE (mont_mul_n11) and BLAKE3 leaf digests (one blake3
    launch) in one device program, each proof's transcript, FRI and
    serialisation on the host. The cold batch's launches are asserted
    (IMP_MONT_MULS mont_mul_n11, one blake3, nothing else); warm batches timed in turns with the native whole-pipeline
    baseline ``_prove_native`` on the same pairs (card, native, native,
    card, card, native), every proof byte-identical; one batch split into
    the upload, the device LDE + commit, the download and the host assembly;
    one under ``torch.profiler`` (busy ms, idle share, mont_mul_n11's card
    time, blake3's); the device program's parts timed alone on the batch's
    traces (the coset LDE, the canonicalisation, the word packing, the leaf
    BLAKE3, the blake3 kernel's launch: CUDA-event ms, busy ms and device
    operations); IMP_PLAIN_PAIRS pairs
    proved on the CPU's plain route, byte-identical; every proof verified by
    the native verifier and by ``verify_improvement_py`` (ms a proof both),
    every envelope by ``verify_improvement``, a tampered proof rejected by
    all three; the native hooks against their goldens."""
    import libzkp_tpu_torch as zkp
    from libzkp_tpu_torch.models import stark, stark_backend as sb
    from libzkp_tpu_torch.ops import blake3_device, kernels, ntt, stark_device as sd
    from libzkp_tpu_torch.ops.field import F128
    from libzkp_tpu_torch.ops.limb import get_context
    from libzkp_tpu_torch.utils.envelope import Proof

    start = time.perf_counter()
    pairs = improvement_pairs()
    kernels.reset_launches()
    t0 = time.perf_counter()
    envs = zkp.prove_improvement_batch(pairs, device=dev)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launches()
    want = dict.fromkeys(kernels.INSTANCES, 0) | {"mont_mul_n11": IMP_MONT_MULS, "blake3": 1}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the improvement batch needs {want}")
    proofs = [bytes(Proof.from_bytes(e).proof[16:]) for e in envs]
    if len(envs) != IMP_PAIRS or len(set(proofs)) != IMP_PAIRS:
        raise AssertionError("prove_improvement_batch returned missing or repeated proofs")
    emit({"phase": "improvement_cold", "proofs": IMP_PAIRS, "ms": cold_ms,
          "proof_bytes": [min(map(len, proofs)), max(map(len, proofs))],
          "launches": {k: v for k, v in counts.items() if v}})

    timed = {"card": [], "native": []}
    for route in ("card", "native", "native", "card", "card", "native"):
        t0 = time.perf_counter()
        if route == "card":
            got = zkp.prove_improvement_batch(pairs, device=dev)
            torch.cuda.synchronize()
        else:
            got = sb._prove_native(pairs)
        timed[route].append((time.perf_counter() - t0) * 1e3)
        if got != (envs if route == "card" else proofs):
            raise AssertionError(f"a warm {route} batch's proofs differ from the cold card batch's")
    card_ms = sum(timed["card"]) / len(timed["card"])
    native_ms = sum(timed["native"]) / len(timed["native"])
    emit({"phase": "improvement_warm", "card": smi("name,power.limit"), "torch_threads": torch.get_num_threads(),
          "batch_ms": timed["card"], "ms_per_batch": card_ms,
          "spread_ms": [min(timed["card"]), max(timed["card"])],
          "ms_per_improvement_proof": card_ms / IMP_PAIRS,
          "native_batch_ms": timed["native"], "native_ms_per_proof": native_ms / IMP_PAIRS,
          "native_spread_ms": [min(timed["native"]), max(timed["native"])],
          "card_over_native": card_ms / native_ms, "identical": True})

    spent: dict = defaultdict(float)
    depth = [0]
    undo = [_wrap(sd, "upload_traces", "upload", spent, depth),
            _wrap(sd, "lde_commit_device", "device_lde_commit", spent, depth),
            _wrap(sd, "download_commit", "download", spent, depth),
            _wrap(stark, "prove", "host_assembly", spent, depth)]
    try:
        t0 = time.perf_counter()
        got = zkp.prove_improvement_batch(pairs, device=dev)
        torch.cuda.synchronize()
        split_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for u in undo:
            u()
    if got != envs:
        raise AssertionError("the split batch's proofs differ")
    split = {f"{k}_ms": v * 1e3 for k, v in spent.items()}
    emit({"phase": "improvement_split", "batch_ms": split_ms, **split,
          "host_prepare_ms": split_ms - sum(split.values())})

    got, prof_ms, busy = profiled(lambda: zkp.prove_improvement_batch(pairs, device=dev))
    if got != envs:
        raise AssertionError("the profiled batch's proofs differ")
    emit({"phase": "improvement_profile", "batch_ms_profiled": prof_ms,
          **busy_summary(busy, prof_ms, mont_mul_n11="mont_mul_kernel<11>", blake3="blake3_kernel")})

    # the device program's parts alone, on the batch's own traces
    ctx = get_context(F128.p)
    airs = [sb.ImprovementAir(sb.TRACE_LENGTH, [o, n], sb.DEFAULT_OPTIONS) for o, n in pairs]
    x = sd.upload_traces(ctx, [sb._build_trace(a, o) for a, (o, _) in zip(airs, pairs)], dev)
    _, lde = ntt.coset_lde_device(ctx, x, IMP_BLOWUP, stark.DOMAIN_OFFSET)
    canon = sd.canon_f128_device(ctx, lde)
    words = sd.limbs_to_u32_words(canon, 16)
    m = torch.nn.functional.pad(words.reshape(-1, 4), (0, 12))
    parts = {"coset_lde": lambda: ntt.coset_lde_device(ctx, x, IMP_BLOWUP, stark.DOMAIN_OFFSET),
             "canonicalise": lambda: sd.canon_f128_device(ctx, lde),
             "words": lambda: sd.limbs_to_u32_words(canon, 16),
             "leaf_blake3": lambda: blake3_device.hash_blocks(m, 16)}
    part_rows = {}
    for name, fn in parts.items():
        _, _, pbusy = profiled(fn)
        part_rows[name] = {"ms": cuda_ms(fn, 5), "device_busy_ms": sum(b[1] for b in pbusy) / 1e3,
                           "device_ops": sum(b[2] for b in pbusy)}
    emit({"phase": "improvement_device_parts", "rows": x.shape[0] * IMP_TRACE * IMP_BLOWUP, **part_rows})

    t0 = time.perf_counter()
    plain = zkp.prove_improvement_batch(pairs[:IMP_PLAIN_PAIRS], device="cpu")
    plain_ms = (time.perf_counter() - t0) * 1e3
    if plain != envs[:IMP_PLAIN_PAIRS]:
        raise AssertionError("the plain route's proofs differ from the card route's")

    t0 = time.perf_counter()
    ok = [sb.verify_improvement(pf, o, n) for pf, (o, n) in zip(proofs, pairs)]
    verify_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ok_py = [sb.verify_improvement_py(pf, o, n) for pf, (o, n) in zip(proofs, pairs)]
    verify_py_ms = (time.perf_counter() - t0) * 1e3
    if not (all(ok) and all(ok_py) and all(zkp.verify_improvement(e, o) for e, (o, _) in zip(envs, pairs))):
        raise AssertionError("an improvement proof was rejected")
    bad = bytearray(proofs[1])
    bad[len(bad) // 2] ^= 0x01
    o, n = pairs[1]
    bad_env = bytearray(envs[1])
    bad_env[len(bad_env) // 2] ^= 0x01
    if (sb.verify_improvement(bytes(bad), o, n) or sb.verify_improvement_py(bytes(bad), o, n)
            or zkp.verify_improvement(bytes(bad_env), o) or zkp.verify_improvement(envs[1], o + 1)):
        raise AssertionError("a tampered improvement proof was accepted")
    emit({"phase": "improvement_verify", "proofs": IMP_PAIRS, "verify_ms_per_proof": verify_ms / IMP_PAIRS,
          "verify_py_ms_per_proof": verify_py_ms / IMP_PAIRS, "tampered_rejected": True,
          "plain_route": {"proofs": IMP_PLAIN_PAIRS, "ms_per_proof": plain_ms / IMP_PLAIN_PAIRS,
                          "identical": True}})
    improvement_native_hooks(pairs)
    emit({"phase": "improvement", "seconds": time.perf_counter() - start})
    return {"counts": counts, "ms_per_batch": card_ms, "split": split}


def device_hash(dev) -> dict:
    """Phase 6e: the device BLAKE3 tier through its entry points at B3_ROWS
    seeded rows of B3_ROW_BYTES bytes: ``hash_leaves_device`` (one blake3
    launch), ``merkle_tree_device`` (one for the leaves and one a level) and
    ``hash_element_rows(F128, rows, device=)`` (one), each with the launch
    counters zeroed just before and read just after, every digest equal to
    the native tier's (``blake3_batch``, ``blake3_merkle_levels``, the
    native route of ``hash_element_rows``); each timed in turns with its
    native counterpart (device, native, native, device, device, native;
    host clock, digests on the host); one call of each entry point under
    ``torch.profiler`` (busy ms, idle share, the kernel's card time)."""
    from libzkp_tpu_torch import native
    from libzkp_tpu_torch.models import merkle
    from libzkp_tpu_torch.ops import blake3_device, kernels
    from libzkp_tpu_torch.ops.field import F128

    start = time.perf_counter()
    rng = random.Random(2214)
    rows = [rng.randbytes(B3_ROW_BYTES) for _ in range(B3_ROWS)]
    elements = [[int.from_bytes(r, "little") % F128.p] for r in rows]
    depth = B3_ROWS.bit_length() - 1

    def native_tree():
        leaves = native.blake3_batch(rows, B3_ROW_BYTES)
        return leaves, native.blake3_merkle_levels(leaves)

    runs = {
        "hash_leaves_device": (lambda: blake3_device.hash_leaves_device(rows, device=dev),
                               lambda: native.blake3_batch(rows, B3_ROW_BYTES), 1),
        "merkle_tree_device": (lambda: blake3_device.merkle_tree_device(rows, device=dev), native_tree,
                               1 + depth),
        "hash_element_rows": (lambda: merkle.hash_element_rows(F128, elements, device=dev),
                              lambda: merkle.hash_element_rows(F128, elements), 1),
    }
    counts = dict.fromkeys(kernels.INSTANCES, 0)
    out = {}
    for name, (on_card, on_host, launches) in runs.items():
        want = on_host()
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = on_card()
        cold_ms = (time.perf_counter() - t0) * 1e3
        got_counts = kernels.launches()
        if got_counts != dict.fromkeys(kernels.INSTANCES, 0) | {"blake3": launches}:
            raise AssertionError(f"{name}: kernel launches {got_counts}, the call needs {launches} blake3")
        if got != want:
            raise AssertionError(f"{name}: the card's digests differ from the native tier's")
        counts["blake3"] += launches
        turns = {"card": [], "native": []}
        for route in ("card", "native", "native", "card", "card", "native"):
            t0 = time.perf_counter()
            got = on_card() if route == "card" else on_host()
            turns[route].append((time.perf_counter() - t0) * 1e3)
            if got != want:
                raise AssertionError(f"{name}: a timed {route} call's digests differ")
        _, prof_ms, busy = profiled(on_card)
        out[name] = {"launches": launches, "cold_ms": cold_ms,
                     "ms": {k: sum(v) / len(v) for k, v in turns.items()}, "turns_ms": turns,
                     "card_over_native": sum(turns["card"]) / sum(turns["native"]),
                     "profile": busy_summary(busy, prof_ms, blake3="blake3_kernel")}
    emit({"phase": "device_hash", "card": smi("name,power.limit"), "rows": B3_ROWS,
          "row_bytes": B3_ROW_BYTES, "levels": depth, "identical": True, **out,
          "seconds": time.perf_counter() - start})
    return {"counts": counts}


def _not_square_encodings(count: int) -> list:
    """The first ``count`` even s whose RFC 9496 decode finds no square
    root: v * u2^2 no square mod p, v = -(d u1^2) - u2^2, u1 = 1 - s^2,
    u2 = 1 + s^2."""
    from libzkp_tpu_torch.ops import ed25519 as ed

    out, s = [], 2
    while len(out) < count:
        u1, u2 = (1 - s * s) % ed.P, (1 + s * s) % ed.P
        v = (-ed.D * u1 * u1 - u2 * u2) % ed.P
        if pow(v * u2 * u2 % ed.P, (ed.P - 1) // 2, ed.P) == ed.P - 1:
            out.append(s.to_bytes(32, "little"))
        s += 2
    return out


def ristretto_device(dev, main: dict = None) -> dict:
    """Phase 6f: the device Ristretto decode and batched encode. Every
    compressed point of the main path's envelopes (each proof's commitment
    V, and A, S, T1, T2 and the six L and R of its two range proofs; the
    proofs are made here when ``main`` does not hold them) and crafted
    encodings (odd s, s >= p, no square root, wrong lengths, random bytes)
    through ``ristretto_decompress_device``, with the launch counters zeroed
    just before and read just after (torch code: none), lane for lane
    against the native ``decompress`` loop, ``None`` included, timed in
    turns with it (card, native, native, card, card, native); the decoded
    points through ``ristretto_compress_device``, equal to their inputs and
    to the native ``compress`` loop, timed in turns likewise; one call of
    each under ``torch.profiler`` (device operations, busy ms, idle
    share)."""
    import libzkp_tpu_torch as zkp
    from libzkp_tpu_torch.models.bulletproofs_backend import BulletproofsBackend as BB
    from libzkp_tpu_torch.models.schemes.common import parse_and_validate_proof, reconstruct_bulletproofs_proof
    from libzkp_tpu_torch.ops import ed25519 as ed, kernels
    from libzkp_tpu_torch.ops.ristretto import ristretto_compress_device, ristretto_decompress_device
    from libzkp_tpu_torch.utils.envelope import SCHEME_RANGE

    start = time.perf_counter()
    if main is None:
        triples = main_triples()
        main = {"envs": zkp.prove_range_batch(triples, device=dev), "triples": triples}
    encodings = []
    for env, (_, lo, hi) in zip(main["envs"], main["triples"]):
        p = parse_and_validate_proof(env, SCHEME_RANGE)
        encodings.append(bytes(p.commitment))
        for rp, _, _, _ in BB.range_instances(reconstruct_bulletproofs_proof(p.proof, p.commitment), lo, hi):
            encodings += [rp.A, rp.S, rp.T_1, rp.T_2, *rp.ipp.L_vec, *rp.ipp.R_vec]
    n_points = len(encodings)
    rng = random.Random(2215)
    encodings += ([(2 * rng.randrange(1 << 250) + 1).to_bytes(32, "little") for _ in range(32)]  # odd s
                  + [(ed.P + 2 * k).to_bytes(32, "little") for k in range(9)]  # s >= p, even
                  + _not_square_encodings(32)
                  + [rng.randbytes(n) for n in (0, 1, 31, 33, 64)]
                  + [rng.randbytes(32) for _ in range(64)])
    want = [ed.decompress(e) for e in encodings]
    if any(w is None for w in want[:n_points]) or all(w is not None for w in want[n_points:]):
        raise AssertionError("the main path's points must decode and some crafted encodings must not")

    kernels.reset_launches()
    got = ristretto_decompress_device(encodings, device=dev)
    if kernels.launches() != dict.fromkeys(kernels.INSTANCES, 0):
        raise AssertionError(f"the Ristretto programs launched kernels: {kernels.launches()}")
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise AssertionError(f"ristretto_decompress_device differs from the native decompress at lanes {bad[:8]}")
    points = [g for g in got if g is not None]
    canonical = [e for e, g in zip(encodings, got) if g is not None]
    runs = {"decompress": (lambda: ristretto_decompress_device(encodings, device=dev),
                           lambda: [ed.decompress(e) for e in encodings], want),
            "compress": (lambda: ristretto_compress_device(points, device=dev),
                         lambda: [ed.compress(q) for q in points], canonical)}
    out = {}
    for name, (on_card, on_host, expect) in runs.items():
        turns = {"card": [], "native": []}
        for route in ("card", "native", "native", "card", "card", "native"):
            t0 = time.perf_counter()
            res = on_card() if route == "card" else on_host()
            turns[route].append((time.perf_counter() - t0) * 1e3)
            if res != expect:
                raise AssertionError(f"ristretto {name}: a timed {route} call differs")
        _, prof_ms, busy = profiled(on_card)
        out[name] = {"ms": {k: sum(v) / len(v) for k, v in turns.items()}, "turns_ms": turns,
                     "card_over_native": sum(turns["card"]) / sum(turns["native"]),
                     "profile": {k: v for k, v in busy_summary(busy, prof_ms).items() if k != "top"}}
    emit({"phase": "ristretto_device", "card": smi("name,power.limit"), "encodings": len(encodings),
          "main_path_points": n_points, "rejected": sum(g is None for g in got), "re_encoded": len(points),
          "identical": True, **out, "seconds": time.perf_counter() - start})
    return {"counts": dict.fromkeys(kernels.INSTANCES, 0)}


def api_batch_ops() -> list:
    """API_OPS seeded ``(kind, args)`` ops, op i of kind API_KINDS[i % 6]:
    distinct range values within their bounds, 64 distinct equality values,
    threshold proofs of 4 values, membership sets of 1 to 64 values (a set
    of 1 and one of 64 among them; set values distinct from every other
    drawn value, so the batch has 128 distinct equality and membership
    values), 64 distinct (old, new) pairs, consistency of 5 values."""
    rng = random.Random(1919)
    per = API_OPS // len(API_KINDS)
    used: set = set()

    def fresh(lo: int = 0, hi: int = (1 << 64) - 1) -> int:
        while True:
            v = rng.randint(lo, hi)
            if v not in used:
                used.add(v)
                return v

    by_kind: dict = {k: [] for k in API_KINDS}
    sizes = [1, 64] + [rng.randint(1, 64) for _ in range(per - 2)]
    for size in sizes:
        lo = rng.randrange(1 << 63)
        hi = lo + rng.randrange(1, 1 << 63)
        by_kind["range"].append((fresh(lo, hi), lo, hi))
        v = fresh()
        by_kind["equality"].append((v, v))
        values = [rng.randrange(1 << 62) for _ in range(4)]
        by_kind["threshold"].append((values, rng.randrange(sum(values) + 1)))
        the_set = [fresh() for _ in range(size)]
        by_kind["membership"].append((rng.choice(the_set), the_set))
        old = fresh(0, (1 << 64) - 2)
        by_kind["improvement"].append((old, fresh(old + 1)))
        by_kind["consistency"].append((sorted(rng.randrange(1 << 64) for _ in range(5)),))
    return [(API_KINDS[i % 6], by_kind[API_KINDS[i % 6]][i // 6]) for i in range(API_OPS)]


def api_verify(kind: str, env: bytes, args) -> bool:
    """``env`` by its kind's own ``verify_*`` on the op's public inputs."""
    import libzkp_tpu_torch as zkp

    if kind == "range":
        return zkp.verify_range(env, *args[1:])
    if kind == "equality":
        return zkp.verify_equality(env, *args)
    if kind == "threshold":
        return zkp.verify_threshold(env, args[1])
    if kind == "membership":
        return zkp.verify_membership(env, args[1])
    if kind == "improvement":
        return zkp.verify_improvement(env, args[0])
    return zkp.verify_consistency(env)


def api_batch(dev) -> dict:
    """Phase 6d: the reference API's batch path, API_OPS ops of all six
    kinds interleaved (``api_batch_ops``) through ``create_proof_batch``,
    the ``batch_add_*`` calls and ``process_batch`` on the card: the MiMC
    pre-hash of the 128 equality and membership values, the equality and
    membership buckets, one Bulletproofs pool of 448 single-proof instances
    (its prover groups and lanes recorded) and the improvements. Cold, with
    the launch counters zeroed just before ``process_batch`` and read just
    after, the seam tables it touches counted against the LRU's size; then
    warm, in turns with the six per-kind batch entry points on the same ops
    (process_batch, per-kind, per-kind, process_batch), each process_batch
    split by bucket, the first one's launches asserted free of table builds;
    one warm batch profiled (busy ms, idle share); every proof verified by
    ``verify_proofs_parallel`` and by its own ``verify_*`` (timed in turns),
    a flipped byte in one proof of each kind rejected by both, a composite
    of one proof of each kind verified; the MiMC pre-hash against per-value
    ``commit_value_snark`` at API_PREHASH_VALUES distinct values, in turns.
    Runs under :func:`seam_tables_kept`, before bp_rest."""
    import libzkp_tpu_torch as zkp
    from libzkp_tpu_torch.models import bp_device, bulletproofs_backend, snark_backend
    from libzkp_tpu_torch.models.schemes import common
    from libzkp_tpu_torch.ops import kernels, msm_device
    from libzkp_tpu_torch.ops.mimc import fr_to_commitment
    from libzkp_tpu_torch.parallel import batch_prover
    from libzkp_tpu_torch.utils.commitment import commit_value_snark
    from libzkp_tpu_torch.utils.envelope import Proof

    start = time.perf_counter()
    snark_backend._get_equality_setup()
    snark_backend._get_membership_setup()
    ops = api_batch_ops()
    counts_by_kind = {k: sum(1 for kk, _ in ops if kk == k) for k in API_KINDS}
    prehash_values = sorted({a[0] for k, a in ops if k in ("equality", "membership")})
    if len(prehash_values) != API_PREHASH_VALUES[0]:
        raise AssertionError(f"{len(prehash_values)} distinct equality and membership values")

    def run():
        bid = zkp.create_proof_batch()
        for kind, args in ops:
            getattr(zkp, f"batch_add_{kind}_proof")(bid, *args)
        out = zkp.process_batch(bid, device=dev)
        torch.cuda.synchronize()
        return out

    split_targets = {
        "prehash": (batch_prover, "snark_commitments"),
        "equality": (batch_prover, "prove_equality_batch"),
        "membership": (batch_prover, "prove_membership_batch"),
        "pool_prepare": (batch_prover, "_prepare"),
        "pool_seam_commits": (bulletproofs_backend, "pedersen_commit_compressed_many"),
        "pool_prove_single_batch": (common, "prove_single_batch"),
        "pool_prove_prepared": (batch_prover, "prove_prepared"),
        "improvement": (batch_prover, "prove_improvement_batch"),
    }

    def split_of(host: dict, batch_ms: float) -> dict:
        ms = {k: v["ms"] for k, v in host.items()}
        pool = {"prepare_ms": ms["pool_prepare"], "seam_commits_ms": ms["pool_seam_commits"],
                "prove_single_batch_ms": ms["pool_prove_single_batch"],
                "finish_ms": ms["pool_prove_prepared"] - ms["pool_prove_single_batch"]}
        buckets = {"prehash_ms": ms["prehash"], "equality_ms": ms["equality"],
                   "membership_ms": ms["membership"],
                   "pool_ms": ms["pool_prepare"] + ms["pool_prove_prepared"],
                   "improvement_ms": ms["improvement"]}
        ops_in = {"equality_ms": counts_by_kind["equality"], "membership_ms": counts_by_kind["membership"],
                  "pool_ms": sum(counts_by_kind[k] for k in ("range", "threshold", "consistency")),
                  "improvement_ms": counts_by_kind["improvement"]}
        return {"batch_ms": batch_ms, **buckets, "pool": pool,
                "registry_and_rest_ms": batch_ms - sum(buckets.values()),
                "ms_per_op": {k[:-3]: buckets[k] / n for k, n in ops_in.items()}}

    # cold: the launches, the seam tables touched, the prover groups
    tables: set = set()
    groups: list = []
    real_get, real_insts = msm_device._get_table, bp_device.prove_insts_device

    def get_table(curve_name, points, where):
        tables.add((curve_name, str(where), tuple(points)))
        return real_get(curve_name, points, where)

    def prove_insts(insts, **kw):
        groups.append(len(insts))
        return real_insts(insts, **kw)

    msm_device._get_table, bp_device.prove_insts_device = get_table, prove_insts
    try:
        kernels.reset_launches()
        with host_timers(**split_targets) as host:
            t0 = time.perf_counter()
            envs = run()
            cold_ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launches()
    finally:
        msm_device._get_table, bp_device.prove_insts_device = real_get, real_insts
    kinds = [k for k, _ in ops]
    if [Proof.from_bytes(e).scheme for e in envs] != [API_KINDS.index(k) + 1 for k in kinds]:
        raise AssertionError("process_batch returned envelopes of the wrong schemes or order")
    path = ("window_sum", "horner", "window_sum4_bn254_g1", "window_sum4_bn254_g2", "horner4_bn254_g1",
            "horner4_bn254_g2", "mont_mul", "mont_mul_n11", "blake3")
    if not all(counts[k] for k in path):
        raise AssertionError(f"process_batch left a kernel of its path unlaunched: {counts}")
    if len(tables) > msm_device._MAX_TABLES:
        raise AssertionError(f"the batch needs {len(tables)} seam tables, the LRU holds {msm_device._MAX_TABLES}")
    emit({"phase": "api_batch_cold", "ops": API_OPS, "by_kind": counts_by_kind, "ms": cold_ms,
          "split": split_of(host, cold_ms), "launches": {k: v for k, v in counts.items() if v},
          "seam_tables": {"touched": len(tables), "lru_size": msm_device._MAX_TABLES,
                          "by_curve_and_points": sorted([c, len(p)] for c, _, p in tables)},
          "pool_groups": {"prove_insts_device_calls": len(groups), "lanes": groups,
                          "instances": sum(groups)}})

    # warm, in turns with the six per-kind batch entry points
    by_kind = {k: [a for kk, a in ops if kk == k] for k in API_KINDS}

    def per_kind():
        out = (zkp.prove_range_batch(by_kind["range"], device=dev)
               + zkp.prove_equality_batch(by_kind["equality"], device=dev)
               + zkp.prove_threshold_batch(by_kind["threshold"], device=dev)
               + zkp.prove_membership_batch(by_kind["membership"], device=dev)
               + zkp.prove_improvement_batch(by_kind["improvement"], device=dev)
               + zkp.prove_consistency_batch([d for (d,) in by_kind["consistency"]], device=dev))
        torch.cuda.synchronize()
        return out

    turns = {"process_batch": [], "per_kind": []}
    splits, warm_counts = [], None
    for route in ("process_batch", "per_kind", "per_kind", "process_batch"):
        kernels.reset_launches()
        with host_timers(**split_targets) as host:
            t0 = time.perf_counter()
            got = run() if route == "process_batch" else per_kind()
            ms = (time.perf_counter() - t0) * 1e3
        turns[route].append(ms)
        if len(got) != API_OPS:
            raise AssertionError(f"the {route} route returned {len(got)} proofs")
        if route == "process_batch":
            splits.append(split_of(host, ms))
            if warm_counts is None:
                warm_counts = kernels.launches()
                built = {k: warm_counts[k] for k in ("pair_add", "pair_add_bn254_g1", "pair_add_bn254_g2")}
                if any(built.values()) or not all(warm_counts[k] for k in path):
                    raise AssertionError(f"the warm batch built a table or skipped a kernel: {warm_counts}")
        else:
            flags = zkp.verify_proofs_parallel(list(zip(got, sorted(kinds, key=API_KINDS.index))))
            if not all(flags):
                raise AssertionError(f"the per-kind route: {flags.count(False)} proofs rejected")
    pb_ms = sum(turns["process_batch"]) / 2
    pk_ms = sum(turns["per_kind"]) / 2
    emit({"phase": "api_batch_warm", "card": smi("name,power.limit"), "torch_threads": torch.get_num_threads(),
          "turns_ms": turns, "ms_per_batch": pb_ms, "ms_per_op": pb_ms / API_OPS,
          "per_kind_ms_per_batch": pk_ms, "process_batch_over_per_kind": pb_ms / pk_ms,
          "warm_launches": {k: v for k, v in warm_counts.items() if v}, "splits": splits})

    got, prof_ms, busy = profiled(run)
    emit({"phase": "api_batch_profile", "batch_ms_profiled": prof_ms,
          **busy_summary(busy, prof_ms, window_sum="window_sum_kernel", horner="horner_kernel",
                         window_sum4_g1=WS4_G1_KERNELS, window_sum4_g2="window_sum4_g2_kernel",
                         horner4="coop_horner_kernel", mont_mul="mont_mul_kernel")})

    # verification: every proof both ways, timed in turns; tampering; a composite
    pairs = list(zip(envs, kinds))
    vtimes = {"verify_proofs_parallel": [], "verify_loop": []}
    for route in ("verify_proofs_parallel", "verify_loop", "verify_loop", "verify_proofs_parallel"):
        t0 = time.perf_counter()
        if route == "verify_loop":
            flags = [api_verify(k, e, a) for e, (k, a) in zip(envs, ops)]
        else:
            flags = zkp.verify_proofs_parallel(pairs)
        vtimes[route].append((time.perf_counter() - t0) * 1e3)
        if flags != [True] * API_OPS:
            raise AssertionError(f"{route}: {flags.count(False)} of {API_OPS} proofs rejected")
    firsts = [kinds.index(k) for k in API_KINDS]
    tampered = []
    for i in firsts:
        bad = bytearray(envs[i])
        bad[len(bad) // 2] ^= 0x01
        tampered.append((bytes(bad), kinds[i]))
    if any(zkp.verify_proofs_parallel(tampered)) or any(
            api_verify(k, e, ops[i][1]) for (e, k), i in zip(tampered, firsts)):
        raise AssertionError("a tampered proof verified")
    if not zkp.verify_composite_proof(zkp.create_composite_proof([envs[i] for i in firsts])):
        raise AssertionError("a composite of one proof of each kind did not verify")
    vpp = sum(vtimes["verify_proofs_parallel"]) / 2
    loop = sum(vtimes["verify_loop"]) / 2
    emit({"phase": "api_batch_verify", "proofs": API_OPS, "turns_ms": vtimes,
          "verify_proofs_parallel_ms_per_proof": vpp / API_OPS, "verify_loop_ms_per_proof": loop / API_OPS,
          "loop_over_parallel": loop / vpp, "tampered_rejected": len(tampered), "composite_verified": True})

    # the MiMC pre-hash against per-value commitments on the host
    rng = random.Random(2020)
    values = list(prehash_values)
    while len(values) < API_PREHASH_VALUES[1]:
        v = rng.randrange(1 << 64)
        if v not in values:
            values.append(v)
    prehash = {}
    for count in API_PREHASH_VALUES:
        vals = values[:count]
        timed = {"device": [], "host": []}
        for route in ("device", "host", "host", "device"):
            t0 = time.perf_counter()
            if route == "device":
                got = [fr_to_commitment(h) for h in zkp.mimc_hash_batch(vals, device=dev)]
            else:
                got = [commit_value_snark(v) for v in vals]
            timed[route].append((time.perf_counter() - t0) * 1e3)
            if route == "host":
                want = got
        if [fr_to_commitment(h) for h in zkp.mimc_hash_batch(vals, device=dev)] != want:
            raise AssertionError(f"the pre-hash at {count} values differs from commit_value_snark")
        prehash[count] = {"turns_ms": timed, "device_ms": sum(timed["device"]) / 2,
                          "host_ms": sum(timed["host"]) / 2}
    emit({"phase": "api_batch_prehash", **{f"values_{k}": v for k, v in prehash.items()}})
    emit({"phase": "api_batch", "seconds": time.perf_counter() - start})
    return {"counts": counts, "ms_per_batch": pb_ms}


def mesh_launches(dp: int, shard: int) -> dict:
    """Launches of the sharded_msm phase on a (dp, shard) mesh: per MSM,
    every block runs 32 windows of one tree_sum and one horner, and each dp
    group folds its shard partial sums with shard - 1 pair_adds. Four G1
    MSMs (a, b_g1, h, l), one G2 (b_g2) and one ed25519."""
    per = 32 * dp * shard
    fold = dp * (shard - 1)
    return {"tree_sum_bn254_g1": 4 * per, "horner_bn254_g1": 4 * per, "pair_add_bn254_g1": 4 * fold,
            "tree_sum_bn254_g2": per, "horner_bn254_g2": per, "pair_add_bn254_g2": fold,
            "tree_sum": per, "horner": per, "pair_add": fold}


def sharded_msm(dev, mesh, tag: str) -> dict:
    """Phase 7: the five query MSMs of one batch of 256 distinct equality
    statements (``groth16._accs_many``'s calls) and one ed25519 MSM of 256
    lanes over the range prover's 130-point basis, each through
    ``msm_many_sharded`` on ``mesh`` with the launch counters zeroed just
    before and read just after, every point equal to the single-device
    route's (v4 for BN254, v3 for ed25519), both routes timed."""
    from libzkp_tpu_torch.models import bp_device, groth16, snark_backend
    from libzkp_tpu_torch.ops import bn254 as bn, curve, ed25519 as ed, kernels, msm_device
    from libzkp_tpu_torch.utils.commitment import commit_value_snark

    pk = snark_backend._get_equality_setup()
    num_instance, csr = snark_backend._equality_shape()
    rng = random.Random(1019)
    values = rng.sample(range(1, 1 << 62), G16_LANES)
    z_list = [snark_backend._equality_assignment(v, v, int.from_bytes(commit_value_snark(v), "little"))
              for v in values]
    h_list = groth16._h_many(pk, z_list, num_instance, csr, device=dev)
    msms = [("b_g2", "bn254_g2", z_list, pk.b_g2_query), ("a", "bn254_g1", z_list, pk.a_query),
            ("b_g1", "bn254_g1", z_list, pk.b_g1_query), ("h", "bn254_g1", h_list, pk.h_query),
            ("l", "bn254_g1", [z[num_instance:] for z in z_list], pk.l_query)]
    basis = bp_device._basis_points(64)
    msms.append(("range_basis", "ed25519", [[rng.randrange(ed.L) for _ in basis] for _ in range(G16_LANES)],
                 basis))
    tables = [msm_device._get_table(c, pts, dev) for _, c, _, pts in msms]
    sharded = [curve.ShardedTable(t.table, t.K, mesh, curve=t.curve) for t in tables]
    if mesh.shape == {"dp": SHARD_DP, "shard": SHARD_SHARD}:
        # phase 3c checked tree_sum at these blocks' shapes
        for c, k in SHARD_K_LOCAL.items():
            if k not in {t.k_local for t in sharded if t.curve == c}:
                raise AssertionError(f"no {c} block of {k} points: phase 3c checked another shape")

    single, single_ms = [], []
    for t, (_, _, vecs, _) in zip(tables, msms):
        t0 = time.perf_counter()
        single.append(curve.msm_many(t, vecs))
        single_ms.append((time.perf_counter() - t0) * 1e3)

    kernels.reset_launches()
    got, mesh_ms = [], []
    for t, (_, _, vecs, _) in zip(sharded, msms):
        t0 = time.perf_counter()
        got.append(curve.msm_many_sharded(t, vecs, mesh))
        mesh_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    counts = kernels.launches()
    want = dict.fromkeys(kernels.INSTANCES, 0) | mesh_launches(mesh.shape["dp"], mesh.shape["shard"])
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the sharded MSMs need {want}")

    affine = {"bn254_g1": bn.g1_to_affine, "bn254_g2": bn.g2_to_affine}
    for (name, c, _, _), a, b in zip(msms, got, single):
        for i, (p, q) in enumerate(zip(a, b, strict=True)):
            same = ed.point_equal(tuple(p), tuple(q)) if c == "ed25519" else affine[c](p) == affine[c](q)
            if not same:
                raise AssertionError(f"{tag} {name} lane {i}: the mesh route's point differs")
    emit({"phase": f"sharded_msm_{tag}", "mesh": mesh.shape, "devices": str(mesh.devices[0][0]),
          "lanes": G16_LANES, "msms": [m[0] for m in msms], "points_equal": True,
          "mesh_ms": mesh_ms, "single_device_ms": single_ms,
          "mesh_over_single_groth16": sum(mesh_ms[:5]) / sum(single_ms[:5]),
          "launches": {k: v for k, v in counts.items() if v}})
    return {"counts": counts}


def groth16_mesh(dev, mesh, g16: dict, tag: str) -> dict:
    """Phase 8: ``prove_equality_batch`` of phase 5's 256 statements with the
    seam on ``mesh`` (``set_mesh``), under phase 5's injected (r, s) draws:
    a cold batch (the five sharded tables built; launches zeroed before and
    read after), then a timed warm batch; every envelope of both equals the
    single-device route's under the same draws."""
    import libzkp_tpu_torch as zkp
    from libzkp_tpu_torch.models import groth16
    from libzkp_tpu_torch.ops import kernels
    from libzkp_tpu_torch.parallel import mesh as meshmod

    def run():
        saved = groth16._rand_fr
        it = iter(g16["draws"])
        groth16._rand_fr = lambda: next(it)
        try:
            t0 = time.perf_counter()
            envs = zkp.prove_equality_batch(g16["pairs"], device=dev)
            torch.cuda.synchronize()
            return envs, (time.perf_counter() - t0) * 1e3
        finally:
            groth16._rand_fr = saved

    pinned = meshmod.current_mesh()
    meshmod.set_mesh(mesh)
    try:
        kernels.reset_launches()
        cold, cold_ms = run()
        counts = kernels.launches()
        warm, warm_ms = run()
    finally:
        meshmod.set_mesh(pinned)
    dp, shard = mesh.shape["dp"], mesh.shape["shard"]
    want = dict.fromkeys(kernels.INSTANCES, 0) | {
        k: v for k, v in mesh_launches(dp, shard).items() if "bn254" in k}
    want["pair_add_bn254_g1"] += 4 * 255  # the four G1 tables, built on the mesh's first device
    want["pair_add_bn254_g2"] += 255
    want["mont_mul"] = H_MONT_MULS  # h runs on the entry device
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the mesh route needs {want}")
    for name, envs in (("cold", cold), ("warm", warm)):
        if envs != g16["seeded_envs"]:
            raise AssertionError(f"{tag} {name} batch: envelopes differ from the single-device route's")
    emit({"phase": f"groth16_mesh_{tag}", "mesh": mesh.shape, "equality_proofs": G16_LANES,
          "cold_ms": cold_ms, "warm_ms": warm_ms, "ms_per_equality_proof": warm_ms / G16_LANES,
          "envelopes_identical": 2 * G16_LANES, "launches": {k: v for k, v in counts.items() if v}})
    return {"counts": counts}


def groth16_h(dev) -> dict:
    """Phase 9: the h crossover. For B in H_BATCHES distinct equality
    statements, ``h_batch_device`` on the card (one call of 43 mont_mul
    launches, encode and decode included) on the native sparse products'
    rows (``native.groth16_spmv``, timed a statement) against the host NTTs
    (``_h_from_evals``, one statement after another) on the pure-Python
    sparse products (``_abc_from_csr``); every h equal. The host time of B
    statements is the sum of their per-statement times."""
    from libzkp_tpu_torch import native
    from libzkp_tpu_torch.models import groth16, snark_backend
    from libzkp_tpu_torch.ops import kernels
    from libzkp_tpu_torch.ops.groth16_device import h_batch_device
    from libzkp_tpu_torch.utils.commitment import commit_value_snark

    num_instance, csr = snark_backend._equality_shape()
    rng = random.Random(1020)
    values = rng.sample(range(1, 1 << 62), max(H_BATCHES))
    zs = [snark_backend._equality_assignment(v, v, int.from_bytes(commit_value_snark(v), "little"))
          for v in values]
    abc = [groth16._abc_from_csr(H_N, num_instance, csr, z) for z in zs]
    packed = groth16._packed_csr(csr)
    t0 = time.perf_counter()
    spmv_rows = [native.groth16_spmv(H_N, len(csr[0][0]) - 1, num_instance, groth16.R, packed, z)
                 for z in zs]
    spmv_ms = (time.perf_counter() - t0) * 1e3 / len(values)
    host, host_ms = [], []
    for az, bz, cz in abc:
        t0 = time.perf_counter()
        host.append(groth16._h_from_evals(H_N, az, bz, cz))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    rows = []
    for B in H_BATCHES:
        args = spmv_rows[:B]
        h_batch_device(H_N, args, groth16.COSET, device=dev)  # warm the shape
        kernels.reset_launches()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = h_batch_device(H_N, args, groth16.COSET, device=dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if kernels.launches()["mont_mul"] != 2 * H_MONT_MULS:
            raise AssertionError(f"h_batch_device made {kernels.launches()['mont_mul']} mont_mul launches "
                                 f"in 2 calls, not {2 * H_MONT_MULS}")
        if got != host[:B]:
            raise AssertionError(f"B = {B}: a device h differs from the host's")
        counts = kernels.launches()
        dev_ms = sum(times) / len(times)
        rows.append({"B": B, "device_ms": dev_ms, "host_ms": sum(host_ms[:B]),
                     "host_over_device": sum(host_ms[:B]) / dev_ms, "device_ms_runs": times})
    emit({"phase": "groth16_h", "n": H_N, "spmv_ms_per_statement": spmv_ms,
          "host_ms_per_statement": sum(host_ms) / len(host_ms), "rows": rows, "h_equal": True})
    return {"counts": counts}  # the last batch size's two timed calls


def mimc_batch(dev) -> dict:
    """Phase 10: ``mimc_hash_batch`` of MIMC_VALUES values on the card, the
    launch counters zeroed just before the cold batch and read just after
    (332 mont_mul launches), then warm batches timed; every digest equal to
    the host ``mimc_hash_native`` (timed too); once more on a one-card dp 2
    mesh (two halves, both on this card), equal."""
    import libzkp_tpu_torch as zkp
    from libzkp_tpu_torch.ops import kernels
    from libzkp_tpu_torch.ops.mimc import mimc_hash_native
    from libzkp_tpu_torch.parallel import mesh as meshmod

    rng = random.Random(1021)
    values = [0, 1, (1 << 64) - 1] + [rng.randrange(1 << 64) for _ in range(MIMC_VALUES - 3)]
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = zkp.mimc_hash_batch(values, device=dev)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launches()
    want = dict.fromkeys(kernels.INSTANCES, 0) | {"mont_mul": MIMC_MONT_MULS}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the MiMC batch needs {want}")
    warm = []
    for _ in range(TIMED_BATCHES):
        t0 = time.perf_counter()
        zkp.mimc_hash_batch(values, device=dev)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    host = [mimc_hash_native(v) for v in values]
    host_ms = (time.perf_counter() - t0) * 1e3
    if got != host:
        raise AssertionError("a MiMC digest of the device batch differs from the host's")
    mesh = meshmod.get_mesh(dp=2, devices=[dev] * 2)
    if zkp.mimc_hash_batch(values, device=dev, mesh=mesh) != host:
        raise AssertionError("a MiMC digest of the dp 2 mesh batch differs from the host's")
    # one warm batch under the profiler: the card's busy time and mont_mul's
    # time a launch
    prof_got, prof_ms, busy = profiled(lambda: zkp.mimc_hash_batch(values, device=dev))
    if prof_got != host:
        raise AssertionError("a MiMC digest of the profiled batch differs from the host's")
    emit({"phase": "mimc_batch", "values": MIMC_VALUES, "cold_ms": cold_ms, "warm_ms": warm,
          "ms_per_batch": sum(warm) / len(warm), "host_ms": host_ms,
          "host_over_device": host_ms / (sum(warm) / len(warm)), "digests_equal": MIMC_VALUES,
          "mesh": {"dp": 2, "equal": True}, "launches": {k: v for k, v in counts.items() if v},
          "profile": {"batch_ms_profiled": prof_ms, **busy_summary(busy, prof_ms, mont_mul="mont_mul_kernel")}})
    return {"counts": counts}


def _plain_collective(name: str, blocks: list, axis: str, dp: int, shard: int) -> list:
    """What collective ``name`` gives on a (dp, shard) grid whose position
    (d, s) holds ``blocks[d][s]``, in numpy (uint32 sums wrap): the
    positions' results in (d, s) order."""
    import numpy as np

    out = []
    for d in range(dp):
        for s in range(shard):
            group = [blocks[k][s] for k in range(dp)] if axis == "dp" else [blocks[d][k] for k in range(shard)]
            me = d if axis == "dp" else s
            n = len(group)
            if name == "psum":
                out.append(np.sum(np.stack(group), axis=0, dtype=np.uint32))
            elif name == "all_gather":
                out.append(np.stack(group))
            elif name == "all_gather_tiled":
                out.append(np.concatenate(group, axis=1))
            elif name == "all_to_all":  # split axis 0, concat axis 1
                out.append(np.concatenate([np.split(g, n, axis=0)[me] for g in group], axis=1))
            elif name == "ppermute":  # the ring i -> i + 1
                out.append(group[(me - 1) % n])
    return out


def ntt_launches(n: int, invert: bool) -> int:
    """mont_mul launches of one ``ntt_device`` of size n: a product a stage,
    a reduce after stage s where s % 4 == 3 and s is not the last, and for
    the inverse n^-1's to_mont and the product by it."""
    log_n = n.bit_length() - 1
    return log_n + (log_n - 1) // 4 + 2 * invert


def ntt_sharded_launches(n: int, shard: int, invert: bool) -> int:
    """mont_mul launches of one ``ntt_sharded_device`` over ``shard``
    positions: on each, to_mont, the size-N1 transforms, the twiddle
    product, the size-N2 transforms and from_mont."""
    from libzkp_tpu_torch.ops import ntt

    n1, n2 = ntt.four_step_shape(n, shard)
    return shard * (3 + ntt_launches(n1, invert) + ntt_launches(n2, invert))


def multi_device(dev) -> dict:
    """Phase 10b: the multi-device layer on a (dp 2, shard 2) mesh whose four
    positions are all this card (it checks the sharding and the per-block
    work, and measures no interconnect): every collective over both axes
    against its plain result; ``ntt_sharded`` at N = 2^18 on BN254 Fr and
    f128, shard 2 and 4, forward and inverse, every value equal to the
    one-device ``ntt_device``'s (BN254 Fr forward also to the native
    ``ntt`` hook), its mont_mul launches asserted, timed against
    ``ntt_device`` in turns, both once under ``torch.profiler`` (the card's
    busy ms and idle share); ``coset_lde_batch`` at the improvement path's
    shapes at dp 1, 2 and 4, equal; ``dryrun_multichip(4)`` and ``(8)``;
    ``init_distributed`` in subprocesses (NCCL, a ``file://`` rendezvous,
    one ``all_reduce`` and the port's ``psum`` and ``all_gather`` over a
    dp that spans them): world 1 on this card, and world 2 where two cards
    are visible. The launch counters are zeroed just before each sharded
    route and read just after, and summed."""
    import os
    import tempfile
    from pathlib import Path

    import numpy as np

    from libzkp_tpu_torch.ops import kernels, ntt
    from libzkp_tpu_torch.ops.field import BN254_FR, F128
    from libzkp_tpu_torch.ops.limb import get_context
    from libzkp_tpu_torch.parallel import collective, mesh as meshmod
    from libzkp_tpu_torch.parallel.dryrun import dryrun_multichip

    start = time.perf_counter()
    counts = dict.fromkeys(kernels.INSTANCES, 0)

    def counted(run):
        kernels.reset_launches()
        out = run()
        torch.cuda.synchronize()
        for k, v in kernels.launches().items():
            counts[k] += v
        return out

    dp, shard = MD_DP, MD_SHARD
    mesh = meshmod.get_mesh(dp=dp, shard=shard, devices=[dev] * (dp * shard))
    rng = np.random.default_rng(1022)
    x = rng.integers(0, 1 << 32, (dp * shard * 4, 8, 3), dtype=np.uint64).astype(np.uint32)
    blocks = [[x[(d * shard + s) * 4 : (d * shard + s + 1) * 4] for s in range(shard)] for d in range(dp)]
    parts = tuple(tuple(torch.from_numpy(b).to(dev) for b in row) for row in blocks)
    runs = {"psum": lambda a: collective.psum(parts, a, mesh=mesh),
            "all_gather": lambda a: collective.all_gather(parts, a, mesh=mesh),
            "all_gather_tiled": lambda a: collective.all_gather(parts, a, mesh=mesh, gather_axis=1, tiled=True),
            "all_to_all": lambda a: collective.all_to_all(parts, a, 0, 1, mesh=mesh),
            "ppermute": lambda a: collective.ppermute(
                parts, a, [(i, (i + 1) % collective.axis_size(a, mesh=mesh))
                           for i in range(collective.axis_size(a, mesh=mesh))], mesh=mesh)}
    checked = []
    for name, run in runs.items():
        for axis in ("dp", "shard"):
            got = [np.asarray(p.cpu()) for row in run(axis) for p in row]
            want = _plain_collective(name, blocks, axis, dp, shard)
            if any(g.dtype != w.dtype or not np.array_equal(g, w) for g, w in zip(got, want, strict=True)):
                raise AssertionError(f"{name} over {axis} differs from its plain result")
            checked.append(f"{name}/{axis}")
    if (collective.axis_index("dp", mesh=mesh), collective.axis_index("shard", mesh=mesh)) != (
            ((0, 0), (1, 1)), ((0, 1), (0, 1))) or collective.axis_size("dp", mesh=mesh) != dp:
        raise AssertionError("axis_index or axis_size differs from the mesh's layout")

    # the four-step NTT against the one-device route, in turns
    ntt_rows = []
    for F in (BN254_FR, F128):
        ctx = get_context(F.p)
        inst = "mont_mul" if ctx.n == 22 else "mont_mul_n11"
        vals = [int.from_bytes(rng.bytes(32), "little") % F.p for _ in range(MD_NTT_N)]
        x_dev = ctx.encode(vals, device=dev)
        for invert in (False, True):
            def single():
                return ctx.from_mont(ntt.ntt_device(ctx, ctx.to_mont(x_dev[None]), invert=invert))[0]

            want = ctx.decode(single())
            if F is BN254_FR and not invert and want != ntt.ntt(F, vals):
                raise AssertionError("ntt_device at 2^18 differs from the native ntt hook")
            for sh in MD_NTT_SHARDS:
                nmesh = meshmod.get_mesh(dp=dp, shard=sh, devices=[dev] * (dp * sh))

                def sharded():
                    return ntt.ntt_sharded_device(ctx, x_dev, nmesh, invert=invert)

                kernels.reset_launches()
                got = counted(sharded)
                need = ntt_sharded_launches(MD_NTT_N, sh, invert)
                if kernels.launches()[inst] != need:
                    raise AssertionError(f"ntt_sharded made {kernels.launches()[inst]} {inst} launches, not {need}")
                if ctx.decode(got) != want:
                    raise AssertionError(f"ntt_sharded over {F.name}, shard {sh}, invert {invert}: values differ")
                turns = defaultdict(list)
                for route, fn in (("ntt_sharded", sharded), ("ntt_device", single), ("ntt_device", single),
                                  ("ntt_sharded", sharded)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    turns[route].append((time.perf_counter() - t0) * 1e3)
                prof = {}
                for route, fn in (("ntt_sharded", sharded), ("ntt_device", single)):
                    _, wall, busy = profiled(fn)
                    summ = busy_summary(busy, wall, mont="mont_mul_kernel")
                    prof[route] = {"wall_ms": wall} | {k: summ[k] for k in (
                        "device_busy_ms", "device_idle_share", "device_ops", "mont")}
                ntt_rows.append({"field": F.name, "n": MD_NTT_N, "shard": sh, "invert": invert, "profile": prof,
                                 "four_step": ntt.four_step_shape(MD_NTT_N, sh), inst: need,
                                 "ntt_device_launches": 2 + ntt_launches(MD_NTT_N, invert),
                                 "ms": {k: sum(v) / len(v) for k, v in turns.items()}, "turns_ms": dict(turns),
                                 "sharded_over_device": sum(turns["ntt_sharded"]) / sum(turns["ntt_device"])})

    # the LDE's dp split at the improvement path's shapes
    traces = [[int.from_bytes(rng.bytes(16), "little") % F128.p for _ in range(IMP_TRACE)]
              for _ in range(IMP_PAIRS)]
    lde_ms, lde_want = {}, None
    for d in MD_LDE_DPS:
        lmesh = meshmod.get_mesh(dp=d, devices=[dev] * d)
        kernels.reset_launches()
        got = counted(lambda: ntt.coset_lde_batch(F128.p, traces, IMP_BLOWUP, 3, device=dev, mesh=lmesh))
        if kernels.launches()["mont_mul_n11"] != d * IMP_MONT_MULS:
            raise AssertionError(f"coset_lde_batch at dp {d}: {kernels.launches()['mont_mul_n11']} mont_mul_n11 "
                                 f"launches, not {d * IMP_MONT_MULS}")
        lde_want = got if lde_want is None else lde_want
        if got != lde_want:
            raise AssertionError(f"coset_lde_batch at dp {d} differs from dp 1")
        t0 = time.perf_counter()
        ntt.coset_lde_batch(F128.p, traces, IMP_BLOWUP, 3, device=dev, mesh=lmesh)
        torch.cuda.synchronize()
        lde_ms[d] = (time.perf_counter() - t0) * 1e3

    dryruns = {}
    for n in MD_DRYRUNS:
        t0 = time.perf_counter()
        out = counted(lambda: dryrun_multichip(n, device=dev))
        dryruns[n] = {"mesh": out["mesh"], "devices": sorted(set(out["devices"])),
                      "seconds": time.perf_counter() - t0}

    worlds = [1] + ([2] if torch.cuda.device_count() > 1 else [])
    dist_rows = []
    for world in worlds:
        with tempfile.TemporaryDirectory() as tmp:
            env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent), OMP_NUM_THREADS="1")
            t0 = time.perf_counter()
            procs = [subprocess.Popen([sys.executable, "-c", DIST_WORKER, str(r), str(world), f"{tmp}/rdzv"],
                                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                     for r in range(world)]
            outs = []
            try:
                for pr in procs:
                    stdout, stderr = pr.communicate(timeout=MD_DIST_TIMEOUT)
                    if pr.returncode != 0:
                        raise AssertionError(f"init_distributed worker failed: {stderr[-2000:]}")
                    outs.append(json.loads(stdout.strip().splitlines()[-1]))
            finally:
                for pr in procs:
                    if pr.poll() is None:
                        pr.kill()
                        pr.wait()
            total = world * (world + 1) // 2
            for r, o in enumerate(outs):
                # member j's rows are arange(2 world) + 10 j: member r gets rows 2r, 2r + 1 of each j,
                # and the ring hands it member r - 1's
                a2a = [2 * r + k + 10 * j for j in range(world) for k in range(2)]
                ring = [k + 10 * ((r - 1) % world) for k in range(2 * world)]
                if (o["backend"], o["all_reduce"], o["psum"], o["all_gather"], o["all_to_all"], o["ppermute"],
                        o["dp"]) != ("nccl", total, total, list(range(1, world + 1)), a2a, ring, world):
                    raise AssertionError(f"init_distributed world {world}: {o}")
            dist_rows.append({"world": world, "seconds": time.perf_counter() - t0,
                              "devices": [o["device"] for o in outs]})

    emit({"phase": "multi_device", "mesh": mesh.shape, "devices": str(dev),
          "note": "every position is this card: no interconnect measured", "collectives_checked": checked,
          "ntt_sharded": ntt_rows, "coset_lde_batch": {"traces": IMP_PAIRS, "blowup": IMP_BLOWUP,
                                                       "ms_by_dp": lde_ms, "equal": True},
          "dryrun_multichip": dryruns, "init_distributed": dist_rows,
          "launches": {k: v for k, v in counts.items() if v}, "seconds": time.perf_counter() - start})
    return {"counts": counts}


# the worker of multi_device's init_distributed check: rank, world size and
# rendezvous file in argv; one all_reduce, then the port's psum and
# all_gather over the dp axis that spans the processes
DIST_WORKER = r"""
import json, sys
import torch
import torch.distributed as dist
from libzkp_tpu_torch.parallel import collective, mesh as meshmod
rank, world, rdzv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dev = torch.device("cuda", rank)
torch.cuda.set_device(dev)
assert meshmod.init_distributed(f"file://{rdzv}", world, rank) is True
t = torch.full((4,), rank + 1, dtype=torch.int64, device=dev)
dist.all_reduce(t)
mesh = meshmod.get_mesh(dp=1, devices=[dev])
parts = meshmod.replicated(mesh).put(torch.tensor([rank + 1], dtype=torch.int32, device=dev))
ps = collective.psum(parts, "dp", mesh=mesh)[0][0]
ag = collective.all_gather(parts, "dp", mesh=mesh, tiled=True)[0][0]
rows = meshmod.replicated(mesh).put(torch.arange(2 * world, dtype=torch.int32, device=dev) + 10 * rank)
a2a = collective.all_to_all(rows, "dp", 0, 0, mesh=mesh)[0][0]
ring = collective.ppermute(rows, "dp", [(i, (i + 1) % world) for i in range(world)], mesh=mesh)[0][0]
torch.cuda.synchronize()
out = {"backend": dist.get_backend(), "all_reduce": int(t[0]), "psum": int(ps[0]),
       "all_gather": ag.tolist(), "all_to_all": a2a.tolist(), "ppermute": ring.tolist(),
       "dp": collective.axis_size("dp", mesh=mesh), "device": str(dev)}
dist.destroy_process_group()
print(json.dumps(out))
"""


def probes_phase(dev) -> dict:
    """Phase 11: P2, P4 (both fields), P5, P6, P7, P1 and P3 through
    ``probes.run``, the launch counters zeroed just before and read just
    after."""
    from libzkp_tpu_torch import probes
    from libzkp_tpu_torch.ops import kernels

    kernels.reset_launches()
    out = probes.run(dev)
    counts = kernels.launches()
    per = 3 + probes.ITERS  # the checked launch, 2 warm-up launches, the timed ones
    want = dict.fromkeys(kernels.INSTANCES, 0) | {
        name: per for name in ("padd_chain", "fe_mul", "fe_mul_bn254_g1", "pair_add", "mont_mul",
                               "mont_padd", "padd_f32_chain")} | {
        kernels.instance("fold_ablate", v): per for v in kernels.ABLATE_VARIANTS}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the probes need {want}")
    emit({"phase": "probes", "probes": out, "launches": {k: v for k, v in counts.items() if v}})
    return {"counts": counts}


def main_triples() -> list:
    """The main path's N_TRIPLES (value, min, max) range statements."""
    rng = random.Random(1016)
    triples = [((1 << 63) + 12345, 0, (1 << 64) - 1)]
    while len(triples) < N_TRIPLES:
        lo = rng.randrange(0, 1 << 62)
        hi = lo + rng.randrange(0, 1 << 62)
        triples.append((rng.randint(lo, hi), lo, hi))
    return triples


def main_path(dev) -> dict:
    """Phase 4: 256 range proofs through the port's entry point."""
    import libzkp_tpu_torch as zkp
    from libzkp_tpu_torch.models import bulletproofs as bp
    from libzkp_tpu_torch.models.bulletproofs_backend import BulletproofsBackend
    from libzkp_tpu_torch.ops import ed25519 as ed, kernels

    triples = main_triples()

    kernels.reset_launches()
    t0 = time.perf_counter()
    envs = zkp.prove_range_batch(triples, device=dev)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = kernels.launches()
    want = dict.fromkeys(kernels.INSTANCES, 0) | {"pair_add": 255, "window_sum": 32 * 10,
                                                  "horner": 32 * 10}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the path needs {want}")
    if len(envs) != N_TRIPLES or any(not isinstance(e, bytes) or len(e) < 1400 for e in envs):
        raise AssertionError("prove_range_batch returned malformed envelopes")
    emit({"phase": "main_path_cold", "range_proofs": N_TRIPLES, "prover_lanes": 2 * N_TRIPLES,
          "seconds": cold_s, "launches": counts})

    batch_s = []
    for _ in range(TIMED_BATCHES):
        t0 = time.perf_counter()
        zkp.prove_range_batch(triples, device=dev)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    ms_batch = sum(batch_s) / len(batch_s) * 1e3  # mean over every timed batch
    emit({"phase": "main_path_warm", "batch_ms": [s * 1e3 for s in batch_s],
          "ms_per_batch": ms_batch, "ms_per_range_proof": ms_batch / N_TRIPLES})

    # one warm batch under the profiler: the card's busy time and K1's and
    # K2's shares of it (320 launches each)
    _, prof_ms, busy = profiled(lambda: zkp.prove_range_batch(triples, device=dev))
    emit({"phase": "main_path_profile", "batch_ms_profiled": prof_ms,
          **busy_summary(busy, prof_ms, window_sum="window_sum_kernel", horner="horner_kernel")})

    sample = list(range(0, N_TRIPLES, max(1, N_TRIPLES // 8)))[:8]
    t0 = time.perf_counter()
    for i in sample:
        value, lo, hi = triples[i]
        if not zkp.verify_range(envs[i], lo, hi):
            raise AssertionError(f"range proof {i} does not verify")
    bad = bytearray(envs[sample[1]])
    bad[len(bad) // 2] ^= 1
    if zkp.verify_range(bytes(bad), *triples[sample[1]][1:]):
        raise AssertionError("a tampered proof verified")
    emit({"phase": "verify_sample", "verified": len(sample), "tamper_rejected": True,
          "seconds": time.perf_counter() - t0})

    # byte-exactness: the device batch under seeded randomness against the
    # host golden prover for 4 lanes
    seeded = random.Random(99)
    insts = []
    for value, lo, hi in triples:
        insts += BulletproofsBackend.prepare_range_bits(value, lo, hi, 64)[0]
    per = (2 * 64 + 4) * 64
    rand = seeded.randbytes(per * len(insts))
    dev_res = bp._prove_batch_fixed_n(insts, 64, rand=rand, device=dev)
    lanes = sorted({0, 1, len(insts) // 2 + 1, len(insts) - 1})
    saved = bp._random_scalar
    try:
        for lane in lanes:
            draws = iter(
                ed.scalar_from_bytes_mod_order_wide(rand[per * lane + 64 * s : per * lane + 64 * s + 64])
                for s in range(2 * 64 + 4)
            )
            bp._random_scalar = lambda d=draws: next(d)
            # the device prover read the transcripts without advancing them
            t, value, blinding, n = insts[lane]
            proof, V = bp.prove_single(t, value, blinding, n)
            if proof.to_bytes() != dev_res[lane][0].to_bytes() or V != dev_res[lane][1]:
                raise AssertionError(f"lane {lane}: device proof differs from the host prover")
    finally:
        bp._random_scalar = saved
    emit({"phase": "byte_exact", "lanes": lanes, "proof_bytes": 672, "identical": True})
    return {"counts": counts, "ms_per_batch": ms_batch, "envs": envs, "triples": triples}


def _wrap(owner, attr: str, label: str, spent: dict, depth: list):
    """Replace owner.attr by a timer that syncs the device around the call;
    only the outermost timed call counts, so nested components do not
    double count. Returns a function that puts the original back."""
    orig = vars(owner)[attr]
    fn = getattr(owner, attr)

    @functools.wraps(fn)
    def timed(*args, **kwargs):
        if depth[0]:
            return fn(*args, **kwargs)
        depth[0] += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            spent[label] += time.perf_counter() - t0
            depth[0] -= 1

    setattr(owner, attr, timed)
    return lambda: setattr(owner, attr, orig)


@contextlib.contextmanager
def host_timers(**targets):
    """Wall ms and calls of each ``(module or class, attribute)`` function
    while the body runs, the attribute wrapped and restored after: the
    host's own cost by part (a part's ms include what it waits on)."""
    out = {k: {"ms": 0.0, "calls": 0} for k in targets}
    saved = {k: getattr(owner, attr) for k, (owner, attr) in targets.items()}

    def wrap(key, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                out[key]["ms"] += (time.perf_counter() - t0) * 1e3
                out[key]["calls"] += 1
        return timed

    for k, (owner, attr) in targets.items():
        setattr(owner, attr, wrap(k, saved[k]))
    try:
        yield out
    finally:
        for k, (owner, attr) in targets.items():
            setattr(owner, attr, saved[k])


def _bp_rest_batch(dev, name: str, n: int, items: list, run, prepare, verify, want: dict,
                   warm_want: dict, timed: int) -> dict:
    """One bp_rest batch: ``run()`` proves ``items`` through the entry point
    (cold, the launch counters zeroed just before and read just after, then
    ``timed`` warm batches on the host clock); ``prepare()`` gives their
    ``(instances, finish)`` pairs for one batch of ``_prove_batch_fixed_n``
    under seeded draws, under the profiler (busy ms, idle share, K1's and
    K2's device ms, the host's parts) with its launches read, and
    BP_REST_LANES of its lanes held byte for byte against the host golden
    ``prove_single`` (timed: the host figure); 8 sampled envelopes of the
    cold batch verified by ``verify(envelope, item)``, a tampered one
    rejected. One line, ``bp_rest_<name>``."""
    import copy

    from libzkp_tpu_torch.models import bulletproofs as bp
    from libzkp_tpu_torch.models.strobe import Transcript
    from libzkp_tpu_torch.ops import curve, ed25519 as ed, kernels, msm_device

    start = time.perf_counter()
    kernels.reset_launches()
    t0 = time.perf_counter()
    envs = run()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = kernels.launches()
    want = dict.fromkeys(kernels.INSTANCES, 0) | want
    if counts != want:
        raise AssertionError(f"{name}: kernel launches {counts}, the batch needs {want}")
    if len(envs) != len(items) or any(not isinstance(e, bytes) for e in envs):
        raise AssertionError(f"{name}: the entry point returned malformed envelopes")

    batch_ms = []
    for _ in range(timed):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    per_proof = [ms / len(items) for ms in batch_ms]

    sample = list(range(0, len(items), max(1, len(items) // 8)))[:8]
    for i in sample:
        if not verify(envs[i], items[i]):
            raise AssertionError(f"{name}: proof {i} does not verify")
    bad = bytearray(envs[sample[1]])
    bad[len(bad) // 2] ^= 1
    if verify(bytes(bad), items[sample[1]]):
        raise AssertionError(f"{name}: a tampered proof verified")

    insts = [inst for pair_insts, _ in prepare() for inst in pair_insts]
    lanes = sorted({0, 1, len(insts) // 2, len(insts) - 1})[:BP_REST_LANES]
    golden = copy.deepcopy([insts[lane] for lane in lanes])  # the lockstep prover advances transcripts
    per = (2 * n + 4) * 64
    rand = random.Random(99).randbytes(per * len(insts))
    kernels.reset_launches()
    with host_timers(seam_msm=(ed, "msm_fixed_many"), table_lookup=(msm_device, "_get_table"),
                     digits=(curve, "_digits_from_scalars"), compress=(ed, "compress"),
                     transcript_challenge=(Transcript, "challenge_bytes")) as host:
        t0 = time.perf_counter()
        res, prof_ms, busy = profiled(lambda: bp._prove_batch_fixed_n(insts, n, rand=rand, device=dev))
        profile_s = time.perf_counter() - t0  # the batch and the profiler's own work
    warm_counts = kernels.launches()
    warm_want = dict.fromkeys(kernels.INSTANCES, 0) | warm_want
    if warm_counts != warm_want:
        raise AssertionError(f"{name}: warm kernel launches {warm_counts}, the batch needs {warm_want}")

    saved = bp._random_scalar
    host_s = []
    try:
        for lane, (t, value, blinding, n_bits) in zip(lanes, golden):
            draws = iter(ed.scalar_from_bytes_mod_order_wide(rand[per * lane + 64 * s : per * lane + 64 * s + 64])
                         for s in range(2 * n + 4))
            bp._random_scalar = lambda d=draws: next(d)
            t0 = time.perf_counter()
            proof, V = bp.prove_single(t, value, blinding, n_bits)
            host_s.append(time.perf_counter() - t0)
            if proof.to_bytes() != res[lane][0].to_bytes() or V != res[lane][1]:
                raise AssertionError(f"{name} lane {lane}: the batch's proof differs from the host prover's")
    finally:
        bp._random_scalar = saved
    host_ms = sum(host_s) / len(host_s) * 1e3
    row = {"phase": f"bp_rest_{name}", "proofs": len(items), "prover_lanes": len(insts), "n_bits": n,
           "cold_s": cold_s, "launches": {k: v for k, v in counts.items() if v},
           "batch_ms": batch_ms, "ms_per_batch": sum(batch_ms) / len(batch_ms),
           "ms_per_proof": sum(per_proof) / len(per_proof), "ms_per_proof_spread": [min(per_proof), max(per_proof)],
           "verified": len(sample), "tamper_rejected": True, "byte_exact_lanes": lanes,
           "proof_bytes": len(res[0][0].to_bytes()),
           "host_prove_single_ms": host_ms, "host_ms_per_proof": host_ms * len(insts) / len(items),
           "host_hooks": "native",
           "seconds": time.perf_counter() - start, "profile_s": profile_s,
           "seeded_batch": {"warm_launches": {k: v for k, v in warm_counts.items() if v},
                            "batch_ms_profiled": prof_ms, "host": host,
                            **busy_summary(busy, prof_ms, window_sum="window_sum_kernel",
                                           horner="horner_kernel")}}
    emit(row)
    return counts


def bp_rest_items() -> tuple:
    """bp_rest's statements: BP_REST_THRESHOLDS threshold pairs (values,
    threshold), BP_REST_SEQUENCES consistency sequences, and for each width
    of BP_REST_WIDTHS N_TRIPLES (value, min, max) range statements."""
    rng = random.Random(1022)
    u64 = (1 << 64) - 1
    pairs = [([u64 - 5, 5], u64)]
    while len(pairs) < BP_REST_THRESHOLDS:
        values = [rng.randrange(1 << 62) for _ in range(rng.randint(1, 4))]
        pairs.append((values, rng.randrange(sum(values) + 1)))
    seqs = [[0, 1, 1 << 63, u64 - 1, u64]]
    while len(seqs) < BP_REST_SEQUENCES:
        seqs.append(sorted(rng.randrange(1 << 64) for _ in range(BP_REST_VALUES)))
    widths = {}
    for n in BP_REST_WIDTHS:
        triples = [((1 << n) - 1, 0, (1 << n) - 1)]
        while len(triples) < N_TRIPLES:
            lo = rng.randrange(1 << 62)
            hi = lo + rng.randrange(1 << n)
            triples.append((rng.randint(lo, hi), lo, hi))
        widths[n] = triples
    return pairs, seqs, widths


def bp_rest(dev, basis_cold: bool) -> dict:
    """Phase 12: the rest of the Bulletproofs backend, each batch through
    :func:`_bp_rest_batch`: BP_REST_THRESHOLDS threshold proofs at 64 bits
    (``prove_threshold_batch``, one device prover batch); BP_REST_SEQUENCES
    consistency proofs of BP_REST_VALUES values (``prove_consistency_batch``:
    each sequence's commitments one seam MSM of 8 lanes, the steps one
    device prover batch), one reaching 2^64 - 1; and at each width of
    BP_REST_WIDTHS, N_TRIPLES range proofs, the proofs of
    ``prove_range_with_bits`` as one batch (``prepare_range_bits``, one
    lockstep host prover batch whose MSMs run through the seam: V at 512
    lanes, A||S, T1||T2 and each round's L||R at 1024 in chunks of 512),
    and ``prove_range_with_bits`` itself once. Launches predicted from the
    code: 32 window_sum and 32 horner launches a device prover MSM (10 a
    batch) and a seam chunk; 255 pair_add launches a cold table (the range
    basis when ``basis_cold``, [B, B_blinding] once, A/S's and the rounds'
    basis at each width). Runs after every phase whose launch counts a
    seam table in the LRU could change."""
    import libzkp_tpu_torch as zkp
    from libzkp_tpu_torch.models.bulletproofs_backend import BulletproofsBackend as BB
    from libzkp_tpu_torch.models.schemes.common import prove_prepared
    from libzkp_tpu_torch.ops import msm_device
    from libzkp_tpu_torch.utils.envelope import SCHEME_RANGE

    start = time.perf_counter()
    pairs, seqs, width_triples = bp_rest_items()
    device_msms = {"window_sum": 32 * 10, "horner": 32 * 10}  # one device prover batch

    counts = [_bp_rest_batch(
        dev, "threshold", 64, pairs,
        run=lambda: zkp.prove_threshold_batch(pairs, device=dev),
        prepare=lambda: [BB.prepare_threshold_bits(v, t, 64) for v, t in pairs],
        verify=lambda env, item: zkp.verify_threshold(env, item[1]),
        want=device_msms | {"pair_add": 255 * basis_cold}, warm_want=device_msms, timed=TIMED_BATCHES)]
    commits = 32 * BP_REST_SEQUENCES  # each sequence's commitments: one seam chunk
    counts.append(_bp_rest_batch(
        dev, "consistency", 64, seqs,
        run=lambda: zkp.prove_consistency_batch(seqs, device=dev),
        prepare=lambda: [BB.prepare_consistency(d, device=dev) for d in seqs],
        verify=lambda env, item: zkp.verify_consistency(env),
        want={k: v + commits for k, v in device_msms.items()} | {"pair_add": 255},
        warm_want=device_msms, timed=TIMED_BATCHES))
    for n, triples in width_triples.items():
        one, two = -(-2 * N_TRIPLES // msm_device.CHUNK_B), -(-4 * N_TRIPLES // msm_device.CHUNK_B)
        chunks = one + two * (2 + n.bit_length() - 1)  # V; A||S, T1||T2 and L||R per round
        seam = {"window_sum": 32 * chunks, "horner": 32 * chunks}

        def prepare(triples=triples, n=n):
            return [BB.prepare_range_bits(v, lo, hi, n) for v, lo, hi in triples]

        counts.append(_bp_rest_batch(
            dev, f"range_{n}", n, triples,
            run=lambda prepare=prepare: prove_prepared([(SCHEME_RANGE, *p) for p in prepare()], device=dev),
            prepare=prepare, verify=lambda env, item: zkp.verify_range(env, *item[1:]),
            want=seam | {"pair_add": 2 * 255}, warm_want=seam, timed=WIDTH_TIMED_BATCHES))
        env = zkp.prove_range_with_bits(*triples[1], n, device=dev)
        if not zkp.verify_range(env, *triples[1][1:]):
            raise AssertionError(f"prove_range_with_bits at {n} bits: the proof does not verify")
    emit({"phase": "bp_rest", "seconds": time.perf_counter() - start})
    return {"counts": {k: sum(c[k] for c in counts) for k in counts[0]}}


def _per_call_us(fn, inputs: list) -> tuple:
    """``fn(*args)`` for each args tuple of ``inputs`` on the host clock:
    (µs a call, results)."""
    t0 = time.perf_counter()
    out = [fn(*args) for args in inputs]
    return (time.perf_counter() - t0) / len(inputs) * 1e6, out


def native_hooks() -> dict:
    """The native host tier's hooks against their pure-Python goldens on this
    machine's host, each on seeded inputs, µs a call both ways; the OpenMP
    team; and the one-MSM calls at several teams (the fixed MSM over the
    verification basis also at several window chunks), two rounds. One line,
    ``native_hooks``."""
    import ctypes
    import os

    from libzkp_tpu_torch import native
    from libzkp_tpu_torch.models.bp_generators import bp_gens, pedersen_gens
    from libzkp_tpu_torch.ops import ed25519 as ed, keccak

    native.load()  # the first call's build check and load stay out of the timings
    rng = random.Random(1600)
    hooks = {}

    def hold(name, nat, py, inputs, same=lambda a, b: a == b):
        py_us, want = _per_call_us(py, inputs)
        nat_us, got = _per_call_us(nat, inputs)
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if not same(g, w)]
        if bad:
            raise AssertionError(f"native {name} differs from its golden at inputs {bad[:8]}")
        hooks[name] = {"calls": len(inputs), "native_us": nat_us, "python_us": py_us,
                       "python_over_native": py_us / nat_us}

    def permuted(perm):
        def run(state):
            buf = bytearray(state)
            perm(buf)
            return bytes(buf)
        return run

    hold("keccak_f1600", permuted(keccak.keccak_f1600_bytes), permuted(keccak.keccak_f1600_bytes_py),
         [(rng.randbytes(200),) for _ in range(256)])
    pts = [ed.from_uniform_bytes(rng.randbytes(64)) for _ in range(256)]
    hold("compress", ed.compress, ed.compress_py, [(p,) for p in pts])
    encs = [ed.compress_py(p) for p in pts[:192]]
    encs += [(ed.P + rng.randrange(19)).to_bytes(32, "little") for _ in range(16)]  # s >= p
    encs += [(rng.randrange(ed.P) | 1).to_bytes(32, "little") for _ in range(16)]  # negative s
    while len(encs) < 256:  # non-square: canonical even s that decode to nothing
        enc = (rng.randrange(ed.P) & ~1).to_bytes(32, "little")
        if ed.decompress_py(enc) is None:
            encs.append(enc)
    hold("decompress", ed.decompress, ed.decompress_py, [(e,) for e in encs],
         same=lambda a, b: (a is None and b is None) or (a is not None and b is not None and ed.ristretto_eq(a, b)))
    rejected = sum(ed.decompress(e) is None for e in encs)
    if rejected != 64:
        raise AssertionError(f"decompress rejected {rejected} of the 64 invalid encodings")
    hold("scalar_mul", ed.scalar_mul, ed.scalar_mul_py,
         [(rng.randrange(ed.L), p) for p in pts[:64]], same=ed.point_equal)
    for n in (1, 2, 7, 33, 130):
        basis = [ed.from_uniform_bytes(rng.randbytes(64)) for _ in range(n)]
        hold(f"msm_{n}", ed.msm, ed.msm_py, [([rng.randrange(ed.L) for _ in basis], basis) for _ in range(8)],
             same=ed.point_equal)
    B, B_blinding = pedersen_gens()
    G, H = bp_gens(64)
    vbasis = [B_blinding, B] + list(G) + list(H)  # the verifier's 130-point basis
    vecs = [[rng.randrange(ed.L) for _ in vbasis] for _ in range(32)]
    ed.msm_fixed(vecs[0], vbasis)  # registers the basis
    hold("msm_fixed_130", ed.msm_fixed, ed.msm_py, [(v, vbasis) for v in vecs], same=ed.point_equal)

    # the one-MSM calls at several OpenMP teams (the wrappers run the
    # budget's from native.TEAM_MIN_POINTS points, else one thread), on the
    # raw calls: the fixed MSM at window chunks 0 (the engine's default), 1
    # and one a thread; the Pippenger MSM at each n
    lib = native.load()
    budget = torch.get_num_threads()
    teams = sorted({1, 2, 4, budget, os.cpu_count() or 1})
    h = native.ed_fixed_handle(tuple(vbasis), vbasis)
    raw = [b"".join((k % ed.L).to_bytes(32, "little") for k in v) for v in vecs]
    out = ctypes.create_string_buffer(128)
    msm_in = {}
    for n in (1, 2, 7, 33, 130):
        pts = vbasis[:n]
        msm_in[n] = (b"".join(native._to_wire(p) for p in pts), [sc[: 32 * n] for sc in raw])
    fixed_sweep, msm_sweep = {}, {}
    try:
        for _ in range(2):
            for team in teams:
                lib.omp_set_num_threads(team)
                for chunks in sorted({0, 1, team}):
                    t0 = time.perf_counter()
                    for sc in raw:
                        lib.zkp_ed_msm_fixed_mt(h, sc, out, chunks)
                    fixed_sweep.setdefault(f"team {team}, chunks {chunks}", []).append(
                        (time.perf_counter() - t0) / len(raw) * 1e6)
                for n, (pb, scs) in msm_in.items():
                    t0 = time.perf_counter()
                    for sc in scs:
                        lib.zkp_ed_msm(n, sc, pb, out)
                    msm_sweep.setdefault(f"n {n}, team {team}", []).append(
                        (time.perf_counter() - t0) / len(scs) * 1e6)
    finally:
        lib.omp_set_num_threads(budget)
    row = {"phase": "native_hooks", "library": str(lib._name), "team": native.max_threads(),
           "torch_threads": budget, "cpu_count": os.cpu_count(), "hooks": hooks,
           "msm_fixed_130_us_by_team": fixed_sweep, "msm_us_by_team": msm_sweep}
    emit(row)
    return row


def _range_insts(triples: list, n: int) -> list:
    """The prover instances of ``triples`` at ``n`` bits (two a proof)."""
    from libzkp_tpu_torch.models.bulletproofs_backend import BulletproofsBackend as BB

    return [inst for v, lo, hi in triples for inst in BB.prepare_range_bits(v, lo, hi, n)[0]]


@contextlib.contextmanager
def seam_tables_kept():
    """Restore the seam's table LRU after the body: a phase that compares
    routes builds tables that a later phase counts as cold."""
    from libzkp_tpu_torch.ops import msm_device

    saved = list(msm_device._TABLES.items())
    try:
        yield
    finally:
        msm_device._TABLES.clear()
        msm_device._TABLES.update(saved)


def native_baseline(dev, triples_by_width: dict) -> dict:
    """The native tier's whole-pipeline prover (``_prove_batch_native``)
    beside the card's route (``_prove_batch_fixed_n``: ``prove_insts_device``
    at 64 bits, ``_prove_batch_lockstep`` with its MSMs on the seam below) on
    the same instances and draws: each route once to warm, then in turns
    native, card, card, native, every proof byte-identical across the runs.
    One line, ``native_baseline``."""
    import copy

    from libzkp_tpu_torch.models import bulletproofs as bp

    rows = {}
    with seam_tables_kept():
        for n, triples in triples_by_width.items():
            insts = _range_insts(triples, n)
            rand = random.Random(99 + n).randbytes((2 * n + 4) * 64 * len(insts))
            routes = {"native": lambda i: bp._prove_batch_native(i, n, rand),
                      "card": lambda i: bp._prove_batch_fixed_n(i, n, rand=rand, device=dev)}
            want, ms = None, {"native": [], "card": []}
            for k, route in enumerate(("native", "card", "native", "card", "card", "native")):
                run = copy.deepcopy(insts)  # the lockstep prover advances its transcripts
                t0 = time.perf_counter()
                res = routes[route](run)
                torch.cuda.synchronize()
                if k >= 2:  # the first of each route warms it
                    ms[route].append((time.perf_counter() - t0) * 1e3)
                got = [(rp.to_bytes(), V) for rp, V in res]
                if want is None:
                    want = got
                elif got != want:
                    raise AssertionError(f"{n} bits: the {route} route's proofs differ from the native route's")
            per = {r: [t / len(triples) for t in v] for r, v in ms.items()}
            rows[n] = {"proofs": len(triples), "instances": len(insts),
                       "native_ms_per_proof": sum(per["native"]) / 2, "card_ms_per_proof": sum(per["card"]) / 2,
                       "native_runs_ms_per_proof": per["native"], "card_runs_ms_per_proof": per["card"],
                       "card_over_native": sum(per["card"]) / sum(per["native"]), "identical": True}
    emit({"phase": "native_baseline", "route_card": {"64": "prove_insts_device", "below": "_prove_batch_lockstep"},
          "widths": rows})
    return rows


def native_verifier(envs: list, triples: list) -> dict:
    """``batch_verify_groups`` (the native RLC verifier) against
    ``batch_verify_groups_py`` on the main path's envelopes, each group one
    envelope's two instances, ms a proof; equal verdicts, all true; then one
    tampered proof, rejected by both while every other group passes. One
    line, ``native_verifier``."""
    import dataclasses

    from libzkp_tpu_torch.models import bulletproofs as bp
    from libzkp_tpu_torch.models.bulletproofs_backend import BulletproofsBackend as BB
    from libzkp_tpu_torch.models.schemes.common import parse_and_validate_proof, reconstruct_bulletproofs_proof
    from libzkp_tpu_torch.utils.envelope import SCHEME_RANGE

    def groups(tamper=None):
        out = []
        for i, (env, (_, lo, hi)) in enumerate(zip(envs, triples)):
            p = parse_and_validate_proof(env, SCHEME_RANGE)
            insts = BB.range_instances(reconstruct_bulletproofs_proof(p.proof, p.commitment), lo, hi)
            if insts is None:
                raise AssertionError(f"envelope {i} does not parse")
            if i == tamper:
                rp, t, V, n = insts[1]
                insts[1] = (dataclasses.replace(rp, t_x=(rp.t_x + 1) % bp.L), t, V, n)
            out.append(insts)
        return out

    row = {"phase": "native_verifier", "proofs": len(envs)}
    tamper = len(envs) // 3
    for tag, target in (("valid", None), ("tampered", tamper)):
        verdicts = {}
        for name, fn in (("native", bp.batch_verify_groups), ("python", bp.batch_verify_groups_py)):
            gs = groups(target)
            t0 = time.perf_counter()
            verdicts[name] = fn(gs)
            row[f"{tag}_{name}_ms_per_proof"] = (time.perf_counter() - t0) * 1e3 / len(envs)
        want = [i != target for i in range(len(envs))]
        if verdicts["native"] != verdicts["python"] or verdicts["native"] != want:
            raise AssertionError(f"{tag}: verdicts native {verdicts['native'].count(True)} true, "
                                 f"python {verdicts['python'].count(True)} true, want {want.count(True)}")
    row["tampered_index"] = tamper
    emit(row)
    return row


class _TeamSpy:
    """Stands in for the native library and records each OpenMP team the
    wrappers set."""

    def __init__(self, lib):
        self.lib, self.teams = lib, []

    def omp_set_num_threads(self, k):
        self.teams.append(k)
        self.lib.omp_set_num_threads(k)

    def __getattr__(self, name):
        return getattr(self.lib, name)


def native_groth16(dev, pairs: list, items: list) -> dict:
    """The native tier's BN254 and Groth16 hooks on this machine's host
    (``native_groth16_hooks``): each held equal to its ``*_py`` golden on
    seeded inputs, µs a call both ways: G1 and G2 ``scalar_mul``, ``msm`` at
    n = 1, 2, 7, 33, 130, ``msm_fixed`` at one point and at the membership
    key's 589-point queries, ``multi_pairing`` at 4 pairs and at N + 3 = 35,
    the sparse products (``groth16_spmv``'s rows against ``_abc_from_csr``'s,
    the pure-Python ``_spmv``) and the h (``groth16_h`` against
    ``_h_from_csr``) of both circuits; the team each one-point call sets; multi-pairings of
    PAIRING_SWEEP pairs serial and on the team, in turns. Then the native
    baseline ``prove_assigned_native``, at each h pool size of
    NATIVE_H_WORKERS, beside the card route ``prove_assigned_many`` on
    phase 5's equality statements and phase 6b's membership statements
    under the same draws, in turns, every proof byte-identical; the fastest
    pool size stands for the baseline (``native_groth16_baseline``); and ``verify`` against
    ``verify_py`` (and in turns with the JAX package's reduced G2 subgroup
    check), the subgroup check alone, ``verify_batch`` in ms a proof
    (``native_groth16_verify``).
    The seam's table LRU is restored after it."""
    import ctypes

    from libzkp_tpu_torch import native
    from libzkp_tpu_torch.models import groth16, snark_backend
    from libzkp_tpu_torch.ops import bn254 as bn
    from libzkp_tpu_torch.utils.commitment import commit_value_snark

    start = time.perf_counter()
    eq_pk, mem_pk = snark_backend._get_equality_setup(), snark_backend._get_membership_setup()
    rng = random.Random(254)
    G1 = bn.g1_from_affine(bn.G1_GEN)
    G2 = bn.g2_from_affine((bn.G2_GEN_X, bn.G2_GEN_Y))
    same1 = lambda a, b: bn.g1_to_affine(a) == bn.g1_to_affine(b)  # noqa: E731
    same2 = lambda a, b: bn.g2_to_affine(a) == bn.g2_to_affine(b)  # noqa: E731
    g1s = [bn.g1_scalar_mul_py(rng.randrange(1, bn.R), G1) for _ in range(130)]
    g2s = [bn.g2_scalar_mul_py(rng.randrange(1, bn.R), G2) for _ in range(130)]
    scalars = lambda k: [rng.randrange(bn.R) for _ in range(k)]  # noqa: E731
    hooks = {}

    def spmv_native(n, ni, csr, z):
        return native.groth16_spmv(n, len(csr[0][0]) - 1, ni, groth16.R, groth16._packed_csr(csr), z)

    def spmv_golden(n, ni, csr, z):
        return tuple(b"".join(v.to_bytes(32, "little") for v in vec)
                     for vec in groth16._abc_from_csr(n, ni, csr, z))

    def hold(name, nat, py, inputs, same=lambda a, b: a == b):
        nat(*inputs[0])  # registers a fixed basis, loads the library: out of the timings
        py_us, want = _per_call_us(py, inputs)
        nat_us, got = _per_call_us(nat, inputs)
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if not same(g, w)]
        if bad:
            raise AssertionError(f"native {name} differs from its golden at inputs {bad[:8]}")
        hooks[name] = {"calls": len(inputs), "native_us": nat_us, "python_us": py_us,
                       "python_over_native": py_us / nat_us}

    hold("g1_scalar_mul", bn.g1_scalar_mul, bn.g1_scalar_mul_py, [(k, p) for k, p in zip(scalars(32), g1s)], same1)
    hold("g2_scalar_mul", bn.g2_scalar_mul, bn.g2_scalar_mul_py, [(k, p) for k, p in zip(scalars(16), g2s)], same2)
    for n in (1, 2, 7, 33, 130):
        hold(f"g1_msm_{n}", bn.g1_msm, bn.g1_msm_py, [(scalars(n), g1s[:n]) for _ in range(4)], same1)
        hold(f"g2_msm_{n}", bn.g2_msm, bn.g2_msm_py, [(scalars(n), g2s[:n]) for _ in range(2)], same2)
    hold("g1_msm_fixed_1", bn.g1_msm_fixed, bn.g1_msm_py, [(scalars(1), [eq_pk.delta_g1]) for _ in range(32)],
         same1)
    hold("g2_msm_fixed_1", bn.g2_msm_fixed, bn.g2_msm_py, [(scalars(1), [eq_pk.vk.delta_g2]) for _ in range(16)],
         same2)
    hold("g1_msm_fixed_589", bn.g1_msm_fixed, bn.g1_msm_py,
         [(scalars(589), mem_pk.a_query) for _ in range(2)], same1)
    hold("g2_msm_fixed_589", bn.g2_msm_fixed, bn.g2_msm_py,
         [(scalars(589), mem_pk.b_g2_query) for _ in range(1)], same2)
    pair_sets = {n: [(g1s[i], g2s[i]) for i in range(n)] for n in (4, 35)}
    hold("multi_pairing_4", bn.multi_pairing, bn.multi_pairing_py, [(pair_sets[4],)])
    hold("multi_pairing_35", bn.multi_pairing, bn.multi_pairing_py, [(pair_sets[35],)])
    for name, get_shape, assign in (
            ("equality", snark_backend._equality_shape,
             lambda v: snark_backend._equality_assignment(v, v, int.from_bytes(commit_value_snark(v), "little"))),
            ("membership", snark_backend._membership_shape,
             lambda i: snark_backend._membership_statement(items[i][0], items[i][1],
                                                           commit_value_snark(items[i][0])))):
        ni, csr = get_shape()
        n = 512 if name == "equality" else MEM_H_N
        keys = [v for v, _ in pairs[:16]] if name == "equality" else list(range(min(16, len(items))))
        zs = [assign(k) for k in keys]
        hold(f"groth16_spmv_{name}", spmv_native, spmv_golden, [(n, ni, csr, z) for z in zs])
        hold(f"groth16_h_{name}", groth16._h_native, groth16._h_from_csr, [(n, ni, csr, z) for z in zs[:4]])

    # the teams: one-point calls serial, the rest on the budget
    spy = _TeamSpy(native.load())
    teams = {}
    saved_lib = native._lib
    native._lib = spy
    try:
        for name, call in (("g1_scalar_mul", lambda: bn.g1_scalar_mul(5, G1)),
                           ("g2_scalar_mul", lambda: bn.g2_scalar_mul(5, G2)),
                           ("g1_msm_fixed_1", lambda: bn.g1_msm_fixed([5], [eq_pk.delta_g1])),
                           ("g2_msm_fixed_1", lambda: bn.g2_msm_fixed([5], [eq_pk.vk.delta_g2])),
                           ("g1_msm_fixed_589", lambda: bn.g1_msm_fixed(scalars(589), mem_pk.a_query)),
                           ("multi_pairing_35", lambda: bn.multi_pairing(pair_sets[35]))):
            spy.teams.clear()
            call()
            teams[name] = spy.teams[0]
    finally:
        native._lib = saved_lib
    if any(teams[k] != 1 for k in ("g1_scalar_mul", "g2_scalar_mul", "g1_msm_fixed_1", "g2_msm_fixed_1")):
        raise AssertionError(f"a one-point call ran on a team: {teams}")

    # multi-pairings serial and on the team, in turns (the library opens its
    # region from 4 pairs; the wrapper sets the team from TEAM_MIN_PAIRS)
    lib = native.load()
    budget = torch.get_num_threads()
    sweep = {}
    big = [(g1s[i % 130], g2s[i % 130]) for i in range(max(PAIRING_SWEEP))]
    try:
        for team in (1, budget, budget, 1):
            lib.omp_set_num_threads(team)
            for n in PAIRING_SWEEP:
                g1b, g2b = native._pairs_wire(big[:n])
                out = ctypes.create_string_buffer(384)
                reps = 3 if n < 100 else 1
                t0 = time.perf_counter()
                for _ in range(reps):
                    lib.zkp_bn254_multi_pairing(n, g1b, g2b, out)
                sweep.setdefault(f"n {n}, team {team}", []).append((time.perf_counter() - t0) / reps * 1e3)
    finally:
        lib.omp_set_num_threads(budget)
    emit({"phase": "native_groth16_hooks", "team": native.max_threads(), "torch_threads": budget,
          "hooks": hooks, "one_point_teams": teams, "team_min_pairs": native.TEAM_MIN_PAIRS,
          "multi_pairing_ms_by_team": sweep})

    # the native baseline beside the card route, same statements and draws
    rows = {}
    with seam_tables_kept():
        for name, pk, shape, zs in (
                ("equality", eq_pk, snark_backend._equality_shape(),
                 [snark_backend._equality_assignment(v, v, int.from_bytes(commit_value_snark(v), "little"))
                  for v, _ in pairs]),
                ("membership", mem_pk, snark_backend._membership_shape(),
                 [snark_backend._membership_statement(v, s, commit_value_snark(v)) for v, s in items])):
            ni, csr = shape
            seeded = random.Random(77)
            draws = [seeded.randrange(1, groth16.R) for _ in range(2 * len(zs))]
            routes = {f"native_w{w}": (lambda w=w: groth16.prove_assigned_native(pk, zs, ni, csr, h_workers=w))
                      for w in NATIVE_H_WORKERS}
            routes["card"] = lambda: groth16.prove_assigned_many(pk, zs, ni, csr, device=dev)
            turns = [*routes, *reversed(routes)]
            want, ms = None, {r: [] for r in routes}
            saved = groth16._rand_fr
            for k, route in enumerate(["native_w2", "card", *turns]):
                it = iter(draws)
                groth16._rand_fr = lambda: next(it)
                try:
                    t0 = time.perf_counter()
                    got = [groth16.proof_to_bytes(p) for p in routes[route]()]
                    torch.cuda.synchronize()
                finally:
                    groth16._rand_fr = saved
                if k >= 2:  # the first of each route warms it
                    ms[route].append((time.perf_counter() - t0) * 1e3)
                if want is None:
                    want = got
                elif got != want:
                    raise AssertionError(f"{name}: the {route} route's proofs differ from the native route's")
            per = {r: sum(v) / len(v) / len(zs) for r, v in ms.items()}
            best = min((r for r in routes if r != "card"), key=per.get)
            rows[name] = {"proofs": len(zs), "native_h_workers": int(best[len("native_w"):]),
                          "native_ms_per_proof": per[best], "card_ms_per_proof": per["card"],
                          "ms_per_proof_by_route": per,
                          "runs_ms_per_proof": {r: [t / len(zs) for t in v] for r, v in ms.items()},
                          "card_over_native": per["card"] / per[best], "identical": True, "proofs_": want}
    emit({"phase": "native_groth16_baseline",
          "routes": {"native": "prove_assigned_native", "card": "prove_assigned_many"},
          **{k: {kk: vv for kk, vv in v.items() if kk != "proofs_"} for k, v in rows.items()}})

    # the verifiers: verify against verify_py on NATIVE_VERIFY proofs of each
    # scheme; verify_batch on all, ms a proof
    out = {}
    for name, pk in (("equality", eq_pk), ("membership", mem_pk)):
        proofs = [groth16.proof_from_bytes(b) for b in rows[name]["proofs_"]]
        if name == "equality":
            public = [[int.from_bytes(commit_value_snark(v), "little")] for v, _ in pairs]
        else:
            public = [snark_backend._membership_public(s, int.from_bytes(commit_value_snark(v), "little"))
                      for v, s in items]
        sample = list(range(NATIVE_VERIFY))
        cases = [(public[i], proofs[i]) for i in sample] + [(public[0], proofs[1])]
        times, verdicts = {}, {}
        for fn in (groth16.verify, groth16.verify_py):
            t0 = time.perf_counter()
            verdicts[fn.__name__] = [fn(pk.vk, x, p) for x, p in cases]
            times[fn.__name__] = (time.perf_counter() - t0) * 1e3 / len(cases)
        if verdicts["verify"] != verdicts["verify_py"] or verdicts["verify"] != [True] * NATIVE_VERIFY + [False]:
            raise AssertionError(f"{name}: verify {verdicts['verify']} against verify_py {verdicts['verify_py']}")
        # verify with the G2 subgroup check ([R - 1]B + B) and with the JAX
        # package's ([R]B reduced mod R: no multiplication), in turns
        checks = {"unreduced": bn.g2_in_subgroup, "reduced": lambda q: bn.g2_is_inf(bn.g2_scalar_mul(bn.R, q))}
        turns = defaultdict(list)
        for which in ("unreduced", "reduced", "reduced", "unreduced"):
            saved, bn.g2_in_subgroup = bn.g2_in_subgroup, checks[which]
            try:
                t0 = time.perf_counter()
                if [groth16.verify(pk.vk, x, p) for x, p in cases] != verdicts["verify"]:
                    raise AssertionError(f"{name}: verify with the {which} subgroup check changed a verdict")
                turns[which].append((time.perf_counter() - t0) * 1e3 / len(cases))
            finally:
                bn.g2_in_subgroup = saved
        t0 = time.perf_counter()
        if not all(bn.g2_in_subgroup(p.b) for p in proofs):
            raise AssertionError(f"{name}: a proof's B failed the subgroup check")
        check_ms = (time.perf_counter() - t0) * 1e3 / len(proofs)
        t0 = time.perf_counter()
        ok = groth16.verify_batch(pk.vk, list(zip(public, proofs)))
        batch_ms = (time.perf_counter() - t0) * 1e3
        if ok != [True] * len(proofs):
            raise AssertionError(f"{name}: verify_batch rejected {ok.count(False)} proofs")
        out[name] = {"verify_ms": times["verify"], "verify_py_ms": times["verify_py"],
                     "subgroup_check_ms": check_ms,
                     "verify_ms_by_subgroup_check": {k: sum(v) / len(v) for k, v in turns.items()},
                     "verify_ms_turns": dict(turns),
                     "py_over_native": times["verify_py"] / times["verify"],
                     "verify_batch_ms_per_proof": batch_ms / len(proofs), "batch_proofs": len(proofs),
                     "verify_over_batch_per_proof": times["verify"] / (batch_ms / len(proofs))}
    emit({"phase": "native_groth16_verify", **out})
    emit({"phase": "native_groth16", "seconds": time.perf_counter() - start})
    return rows


def native_phase(dev, main: dict = None) -> None:
    """The native host tier on the card machine's host: its hooks against
    their goldens, its whole-pipeline prover beside the card's route at 64
    bits (the main path's statements) and at 8, 16, 32 bits (bp_rest's), and
    its RLC verifier against the pure-Python one on the main path's
    envelopes (proved here when ``main`` does not hold them); then the BN254
    and Groth16 half (:func:`native_groth16`) on phase 5's and phase 6b's
    statements."""
    import libzkp_tpu_torch as zkp

    start = time.perf_counter()
    native_hooks()
    _, _, widths = bp_rest_items()
    native_baseline(dev, {64: main_triples(), **widths})
    if main is None:
        triples = main_triples()
        main = {"envs": zkp.prove_range_batch(triples, device=dev), "triples": triples}
    native_verifier(main["envs"], main["triples"])
    native_groth16(dev, equality_pairs(), membership_items())
    emit({"phase": "native", "seconds": time.perf_counter() - start})


def main(argv: list) -> int:
    flags = ("--kernels", "--range", "--groth16", "--g1", "--mont", "--ed-tree", "--ed-pair", "--f32-chain",
             "--ed-chain", "--mont-padd", "--fe-mul", "--bp-rest", "--native", "--membership",
             "--improvement", "--api", "--multi-device", "--device-hash", "--ristretto")
    if len(argv) > 1 or (argv and argv[0] not in flags):
        print(f"usage: python3 chip_smoke.py [{' | '.join(flags)}], got {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from libzkp_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    name_power = smi("name,power.limit")
    sm_clock_mhz = float(smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(dev)
    int_rate = props.multi_processor_count * INT32_LANES_PER_SM * sm_clock_mhz * 1e6
    fp32_rate = props.multi_processor_count * FP32_LANES_PER_SM * sm_clock_mhz * 1e6
    # P3's plain version is float32 matrix products that must be exact: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "card", "nvidia_smi": name_power, "torch_name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "sm_count": props.multi_processor_count,
          "max_sm_clock_mhz": sm_clock_mhz, "int32_mac_per_s": int_rate, "fp32_fma_per_s": fp32_rate,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from concurrent.futures import ThreadPoolExecutor

    from libzkp_tpu_torch import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ for the native tier beside the nvcc builds
        native_build = pool.submit(native.build)
        kernels.build()
        native_path, native_s = native_build.result()
    ptxas = {
        n: [ln.strip() for ln in (kernels.BUILD_DIR / f"{n}.log").read_text().splitlines()
            if "ptxas info" in ln or "stack frame" in ln]
        for n in kernels.LIBRARIES
        if (kernels.BUILD_DIR / f"{n}.log").exists()
    }
    summary = {key: ptxas_summary((kernels.BUILD_DIR / f"{lib}.log").read_text(), names)
               for key, (lib, *names) in PTXAS_KERNELS.items() if (kernels.BUILD_DIR / f"{lib}.log").exists()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas, "ptxas_summary": summary,
          "native": {"compiler": native.CXX, "flags": list(native.CXXFLAGS), "library": str(native_path),
                     "seconds": native_s}})

    from libzkp_tpu_torch.parallel import mesh as meshmod

    # a one-position mesh pins the seam to the single-device route (v3, v4)
    # on any number of cards, so phases 4 to 6 and phase 8's reference
    # envelopes never take the mesh route
    meshmod.set_mesh(meshmod.get_mesh(dp=1, devices=[dev]))
    if argv == ["--range"]:  # the main path alone, to run two checkouts in turns
        main_path(dev)
        return 0
    if argv == ["--groth16"]:  # the Groth16 phases alone, likewise
        groth16_path(dev)
        groth16_grouped(dev)
        return 0
    if argv == ["--g1"]:  # window_sum4 G1 and pair_add G1 alone, likewise
        g1_pair(dev)
        return 0
    if argv == ["--mont"]:  # mont_mul alone and the MiMC batch, likewise
        mont_pair(dev)
        mimc_batch(dev)
        return 0
    if argv == ["--ed-tree"]:  # tree_sum ed25519 alone, likewise
        ed_tree_pair(dev)
        return 0
    if argv == ["--ed-pair"]:  # pair_add ed25519 alone, likewise
        ed_pair(dev)
        return 0
    if argv == ["--f32-chain"]:  # padd_f32_chain alone, likewise
        f32_chain(dev)
        return 0
    if argv == ["--ed-chain"]:  # padd_chain alone, likewise
        ed_chain(dev)
        return 0
    if argv == ["--mont-padd"]:  # mont_padd alone, likewise
        mont_padd_pair(dev)
        return 0
    if argv == ["--fe-mul"]:  # fe_mul alone, likewise
        fe_mul_pair(dev)
        return 0
    if argv == ["--bp-rest"]:  # the rest of the Bulletproofs backend alone
        bp_rest(dev, basis_cold=True)
        return 0
    if argv == ["--native"]:  # the native host tier alone
        native_phase(dev)
        return 0
    if argv == ["--membership"]:  # the membership path alone
        membership(dev)
        return 0
    if argv == ["--improvement"]:  # mont_mul's and blake3's checks and the improvement path alone
        check_mont_kernels(dev, int_rate)
        check_blake3_kernel(dev, int_rate)
        improvement(dev)
        return 0
    if argv == ["--device-hash"]:  # blake3's checks and the device BLAKE3 tier alone
        check_blake3_kernel(dev, int_rate)
        device_hash(dev)
        return 0
    if argv == ["--ristretto"]:  # the device Ristretto decode and encode alone
        ristretto_device(dev)
        return 0
    if argv == ["--api"]:  # the reference API's batch path alone
        api_batch(dev)
        return 0
    if argv == ["--multi-device"]:  # the multi-device layer alone
        multi_device(dev)
        return 0
    tables: dict = {}
    checks = (check_kernels(dev, int_rate, tables) + check_bn254_kernels(dev, int_rate, tables)
              + check_sharded_kernels(dev, int_rate, tables)
              + check_probe_kernels(dev, int_rate, fp32_rate) + check_mont_kernels(dev, int_rate)
              + check_blake3_kernel(dev, int_rate))
    del tables
    check_membership_shapes(dev, int_rate)
    if argv == ["--kernels"]:  # the kernel checks alone, to time two checkouts in turns
        return 0
    main = main_path(dev)
    paths = [main]
    g16 = groth16_path(dev)
    paths += [g16, groth16_grouped(dev)]
    with seam_tables_kept():  # its five query tables leave the LRU as they found it
        paths.append(membership(dev))
    paths += [improvement(dev), device_hash(dev), ristretto_device(dev, main)]
    with seam_tables_kept():  # bp_rest counts the consistency commits' table as cold
        paths.append(api_batch(dev))
    # the mesh route on one card: four positions, all cuda:0 (no interconnect)
    meshes = [("one_card", meshmod.get_mesh(dp=SHARD_DP, shard=SHARD_SHARD, devices=[dev] * 4))]
    if torch.cuda.device_count() > 1:
        n_dev = torch.cuda.device_count()
        meshes.append(("devices", meshmod.get_mesh(shard=2 if n_dev % 2 == 0 else 1)))
    for tag, mesh in meshes:
        paths += [sharded_msm(dev, mesh, tag), groth16_mesh(dev, mesh, g16, tag)]
    paths += [groth16_h(dev), mimc_batch(dev), multi_device(dev), probes_phase(dev)]
    native_phase(dev, main)
    # last: its seam tables enter the LRU after every phase that counts
    # launches of cached tables; main_path built the range basis's table
    paths.append(bp_rest(dev, basis_cold=False))
    # launches of each instance summed over the paths that run it
    launched = {name: sum(p["counts"][name] for p in paths) for name in kernels.INSTANCES}
    if sorted(r["name"] for r in checks) != sorted(kernels.INSTANCES):
        raise AssertionError("a kernel instance was not checked against its plain version")
    if not all(launched.values()):
        raise AssertionError(f"instances no path launched: {[k for k, v in launched.items() if not v]}")

    emit({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces")}
        | {"launches": launched[r["name"]]}
        | {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in checks
    ]})
    print(name_power, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
