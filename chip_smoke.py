#!/usr/bin/env python3
"""Drive the ntt_tpu_torch main path once on one CUDA card.

    python chip_smoke.py [--seed SEED]

Phases, each of which raises on failure (nothing is caught):

1. device: require a CUDA card; print its name and power limit;
2. build: compile the CUDA kernels of ntt_tpu_torch/csrc with nvcc for
   sm_90a, one nvcc per source, all started together; print the time and
   ptxas's register report, and each lab transform's (L1 / L2
   instantiations and L3 probes by name) registers and spills; count a
   butterfly's SASS instructions and multiplies (``ntt_tpu_torch.sass``),
   Shoup and Solinas, and the innermost loops of diag_mul (one multiply a
   32-bit half of a group a step, at every group size: no chain folded)
   and diag_math (its 8 butterflies a round);
3. kernel vs plain: at N = 2^14, batch 128, for a 62-bit q and a q < 2^30,
   run K1 (fwd_fused, strict and lazy), K2 (inv_fused) and K3 (mul_mod) on
   the card and require each output to equal, bit for bit, the plain
   PyTorch version run on the same CUDA tensors; check two rows of each
   against exact big-int arithmetic on the host;
4. K1 / K2 at every size they serve: at both widths and every m from 1 to
   fused.max_logn(word) (14 at word 64, 15 at word 32), batch 3, and at
   m = 14 batch 500 (more than one wave of blocks), K1 strict and lazy on
   inputs below 4q and K2 equal to their plain versions, bit for bit; K2
   with a final-stage constant one bit wider than the word at m = 3 (N
   below the 16 words a thread holds) and m = 14;
5. main path within one block: with every launch count set to 0, the HE
   batch of 1024 polynomials through api.negacyclic_mul, a batch-128
   round trip inv_ntt(fwd_ntt(a)) == a at both widths, and the reference
   fixtures 0 to 14 (m 8-15) through 'auto'; the products must equal the
   plain path's and, at sampled coefficients, the schoolbook negacyclic
   convolution, the fixtures' forwards the plain path's and the NTT by
   definition at sampled outputs; K1, K2 and K3 must have been launched;
6. two-pass kernels vs plain: K4 (fwd_cols), K5 (fwd_rows, strict and
   lazy, both output layouts), K6 (inv_rows, both input layouts) and K7
   (inv_cols, also with a final-stage constant one bit wider than the
   word) against their plain versions, bit for bit, at N = 2^16 batch 128
   and N = 2^20 batch 16 at both widths and N = 2^24 batch 1 at 62 bits;
   at N = 2^16 two rows of the forward against the NTT by its definition;
7. K4-K7 at every m they serve in the API: at both widths and every m
   from 1 to 24 at the API's split (the 'sixstep' variant takes any m; its
   split gives N1 = 2 up to m = 8 and N2 = 1 at m = 1, so every
   instantiation of 2, 4, 8 and 16 words a thread runs), batch 3 (1 from
   m = 21, where the plain versions take most of the time), and at m = 16
   batch 300 (more than one wave of blocks), K4 on inputs below 4q,
   K5 strict and lazy in both output layouts, K6 from both input layouts
   (and equal between them), K7, and K7 with a final-stage constant one
   bit wider than the word equal to their plain versions, bit for bit;
8. main path beyond one block: with every launch count set to 0, the CKKS
   product of 128 residue polynomials at N = 2^16 (both widths), round
   trips at N = 2^20 (batch 16, both widths) and N = 2^24 (batch 1), and
   the reference fixtures 15 to 18 through 'auto'; products equal to the
   plain path's and to the schoolbook product at sampled coefficients,
   round trips exact; K4 to K7 must have been launched at both widths;
9. K8 and 'sixstep-rec' vs plain: at both widths and every m from 2 to
   24, batch 3 (and K8 at m16 batch 128; the two-level transforms batch 1
   from m = 21), K8 (twist_mul) with the forward
   and the inverse twist on inputs below 4q equal to its plain version;
   the two-level forward (K4 at the rec split, K8, K1), strict and lazy,
   and its inverse (K2, K8, K7 with the level-1 constants) equal to the
   plain compositions (``rec.plain_fwd`` / ``plain_inv``), the strict
   forward equal to the flat 'sixstep', the round trip exact;
10. the rec slice's main path: with every launch count set to 0,
   ``fwd_ntt`` / ``inv_ntt`` through 'sixstep-rec' at m24 (word 64, 128 MB)
   and m23 (word 32), batch 1, and through 'auto' at the first cell of
   ``api.REC_CELLS`` (word 32, m17, batch 128), ``api.DeviceNtt.negacyclic``
   at m14 q62 batch 1024 (strict and lazy handle) and a
   ``rns.DeviceRnsTower`` of three 30-bit primes at m14 batch 1024, and the
   tower's big-int product at batch 1; round trips exact, forwards equal
   to the flat 'sixstep', the handles' products equal to
   ``api.negacyclic_mul`` and to the schoolbook product at sampled
   coefficients, the tower's equal to the host tower's and its big-int
   product to the schoolbook one over Python ints; K1-K4, K7 and K8 must
   have been launched at both widths;
11. lab kernels vs plain: at N = 2^14, batch 32, n1_log 7 (and 4), both
   widths, inputs below 4q: L1 (fwd_fused_v2, two-stage and one-stage
   rounds, strict and lazy), L2 (fwd_fused_v3, strict, lazy, kept
   transposed) and the four L3 probes against their plain versions, bit
   for bit; L1 (both groups) and L2 (on K1's design point) also at every m
   from 1 to fused.max_logn(word), both widths, batch 3, n1_log 1, m // 2,
   m - 1 and m, strict and lazy, both layouts, and L2 against K1, and
   diag_math against its plain version at m rounds and equal to its input
   at 0; diag_copy, diag_moves and diag_mul (all four probes run K1's
   design point) also against ``clone`` / ``flip(-1)`` / ``plain_mul`` at
   every m from 1 to fused.max_logn(word), both widths, batch 1, 3 and
   133, any word pattern, and at m14 batch 3 on a tensor that is not
   16-byte aligned;
12. the lab path: with every launch count set to 0,
   ``python -m ntt_tpu_torch.lab --cases both --no-time`` (N = 2^14, batch
   512): every forward candidate equal to the plain six-step and to K1's
   output, K2 to the plain inverse, every probe to its plain version; K1
   and every L1 / L2 / L3 kernel must have been launched at both widths;
13. reference-family variants vs plain: every variant of FAMILY at the
   widths it takes (word 64, and the int32 rep where a word-64 variant
   computes on an int64 copy), at every m from its least (hexl 3, r2-16
   4, the vector forms 8) to 16, batch 3, and at m20 batch 2 and m24
   batch 1 at word 64: the strict and lazy forward and the inverse
   through the API (K9 / K10; K1 / K2 / K4-K7 for radix4x4) equal to the
   variant's plain versions run on the same CUDA tensors, the lazy output
   below its bound, the strict one equal to 'sixstep''s after
   output_layout's fix, the round trip exact; every (entry point, stage
   mode, twiddle view) of K9 / K10 run; each entry point on one stage at
   m14 batch 1024 equal to its plain version;
14. the variant slice's main path: with every launch count set to 0, the
   HE product of each variant at m14 batch 1024 at its widest q
   (FAMILY_HE) equal to 'auto''s; all five K9 / K10 entry points and K1 /
   K2 (radix4x4) must have been launched;
15. K11 vs plain: ``kernels.mxu.limb_matmul`` in both contracts, with and
   without the fused scale, against ``limb_matmul_plain`` on the same CUDA
   tensors, bit for bit, at every m from 1 to 20 (batch 2^(20 - m), the
   balanced split) and at m24 batch 1, at q = 0xfff0001 (FIXTURES[8], the
   widest 28-bit fixture q) and q = 0x10001, on limb matrices over the
   whole range 0..127; and the worst case at the deepest K, m24 (K = 4096
   in both contracts): every matrix limb 127 and every x word 0x0fffffff
   (every limb 127); the body K11 ran at each m (``mxu.body``: wgmma from
   K = 128, mma.sync below) is printed;
16. the mxu slice's main path: with every launch count set to 0,
   ``fwd_ntt`` / ``inv_ntt`` through 'mxu' at the same m (batch 3, 1 at
   m24; q = 0xfff0001 up to m15, the largest 28-bit NTT prime of N beyond)
   and ``negacyclic_mul(variant="mxu")`` at m14 batch 1024: strict and lazy
   forwards equal to 'auto''s, round trips exact, the product equal to
   'auto''s and to the schoolbook product at sampled coefficients; both
   K11 contracts and K3 must have been launched;
17. the CLI on the card: ``python -m ntt_tpu_torch list`` names the
   registry, and with every launch count set to 0 ``correctness --full
   --device cuda`` in-process runs every variant on the 19 reference
   fixtures: every line OK or SKIP (pallas-fused beyond one block),
   ``FAILURES: 0``, and every kernel of the API but K3 launched;
18. Solinas instantiations vs plain: with ``modmath.USE_SOLINAS`` set (and
   restored in a ``finally``), every kernel that the NTT_MULMOD=solinas
   switch reaches in its Solinas instantiation, at q = 2^e - 2^k + 1 of
   ``find_solinas_ntt_prime``, against its plain version under the switch,
   bit for bit: K1 (strict, lazy, inputs < 4q) and K2 at every m from 1 to
   14 at 2^62 - 2^16 + 1 and to 10 at 2^27 - 2^11 + 1; K4-K7 (K5 both
   layouts, K6 from both) at every m from 1 to 24 at 2^61 - 2^26 + 1 and
   to 10 at the 27-bit q; K8 at m16-m24 and m2-m10, 'sixstep-rec' at m10,
   16, 20, 24; the K9 / K10 variants (SOLINAS_FAMILY) through the API at m14
   batch 1024 (m10 at word 32) and one stage of each entry point on lazy
   inputs (below 4q for K9, 8q for K10); K3 and
   K11 (strict outputs) equal with and without the switch;
19. the Solinas path: with every launch count set to 0, under the switch,
   ``negacyclic_mul`` at q62 m14 batch 1024, q61 m16 batch 128 and q27
   m10 batch 1024 (``auto``, and 'sixstep' at q27), the K9 / K10
   variants' products, round trips at m20 batch 16 and m24 batch 1 (and
   q27 m10) through ``auto`` and 'sixstep-rec', and ``DeviceNtt.negacyclic``
   at m14 batch 1024; every Solinas entry point must have been launched and
   no Shoup one of K1, K2, K4-K10; each product equal to the same call with
   the switch off and to the schoolbook product at sampled coefficients,
   each round trip exact;
20. the switch from the environment: ``NTT_MULMOD=solinas python -m
   ntt_tpu_torch correctness --full --device cuda`` in a subprocess must
   exit 0 and print ``FAILURES: 0``;
21. Solinas against Shoup times: each Solinas instantiation from a CUDA
   graph beside its Shoup one at the same q and shape (Shoup, Solinas,
   Solinas, Shoup), its plain version under the switch, and its bound
   recomputed for the switched work (no Shoup-constant bytes of the single
   products, the Solinas product's multiplies counted from its SASS in the
   build phase): K1 / K2 at m14 batch 1024 (m10 batch 16384 at word 32),
   K4-K7 at m16 b128, m20 b16, m24 b1 (and the 27-bit q at m10), K8 at m24
   (and m10), one K9 / K10 stage;
22. Solinas lab kernels vs plain: under the switch, at the lab's q where it
   takes the Solinas product (``bench_params(14, 62)`` = 2^62 - 2^16 + 1 at
   m14, ``NttParams.generate(27, 10)`` = 2^27 - 2^11 + 1 at m10), batch 32,
   inputs below 4q: L1 (both groups; strict, lazy, kept transposed; and at
   n1_log 4), L2 (the same layouts) and ``diag_math`` (m rounds; 0 rounds
   equal to its input) against their plain versions, bit for bit, L2
   against K1; L1, L2 and ``diag_math`` at every m each q serves within
   one block (m1-m14 at word 64, m1-m10 at word 32) as in phase 11; L1 and L2 at an N beyond one block's shared memory
   refused by the Shoup and the Solinas launchers alike;
23. the lab path under the switch: with every launch count set to 0,
   ``python -m ntt_tpu_torch.lab --cases both --no-time`` at m14 and at
   m10 (batch 512): every candidate bit-exact; at the switched width (word
   64 at m14, word 32 at m10) every Solinas lab entry point (L1 of both
   groups, L2, ``diag_math``) and K1 / K2's launched, and no Shoup L1 / L2
   / ``diag_math``;
24. the HE demo: ``python -m ntt_tpu_torch.examples.he_demo --check`` at its
   defaults (m10, three 30-bit channels, batch 4) in-process: the big-int
   product equal to the schoolbook one, device time between CUDA events;
25. fuzz draws: tests/test_torch_fuzz.py's draw from ``--seed`` (a (q_bits,
   m) pair redrawn until it has an NTT prime) at 13-29 bits / m6-m9, 31-60
   bits / m6-m9 and 62 bits / m6-m8: radix2, sixstep, radix4 and r4r2
   (q_bits <= 60), radix4-w56 (q_bits <= 52) through the API on the card,
   each forward equal to its plain version and, at sampled outputs, to the
   NTT by its definition, the lazy one within its bound, the round trip
   exact; a negacyclic_mul at m5 equal to the schoolbook product;
26. Solinas lab times: each Solinas lab kernel (L1 both groups, L2,
   ``diag_math``) from a CUDA graph beside its Shoup twin at the same q
   and shape (Shoup, Solinas, Solinas, Shoup; m14 batch 512 at word 64,
   m10 batch 8192 at word 32), its plain version under the switch at batch
   32, and its bound for the switched work: the kernel table's
   ``*_solinas_*`` lab rows;
27. the Solinas product alone: ``kernels.pointwise.solinas_mul`` (a check
   on no transform path, ``SolinasRed::mul`` element-wise) against the
   plain ``modmath.mul_mod_q2_solinas`` / ``mul_mod32_q2_solinas`` on the
   same CUDA tensors, bit for bit, at tests/test_torch_solinas.py's q of
   each form and its operand sets: w < q and t below 4q or 8q with the
   edges, the whole word with 0 and 2^word - 1, and 2^22 more pairs a q
   over the whole word;
28. shard kernels vs plain (the dist slice): at the two-pass sizes of phase
   6 and the dist path's default split for D = 2 and 8 (N1 raised to D),
   K5 (strict, lazy, both output layouts) and K6 (from both layouts) on
   the rows of every shard, [d N1/D, (d + 1) N1/D), and on the four chunks
   of the last one (n_chunks 4), K4 and K7 (the whole transform's n^-1) on
   N2/D lanes, and K8 with both twists on every row shard of the rec
   split, against their plain versions on the same CUDA tensors, bit for
   bit; K5 / K6 on one shard under the switch at 2^61 - 2^21 + 1 (m20),
   their Solinas instantiations launched;
29. the dist slice's main path: with every launch count set to 0,
   ``dist_fwd_ntt`` (strict, lazy; n_chunks 1 and 4), ``dist_inv_ntt``
   (n_chunks 1 and 4), ``dist_negacyclic_mul`` (n_chunks 1 and 4),
   ``dist_rec_fwd_ntt`` (strict, lazy) / ``dist_rec_inv_ntt`` and
   ``batch_parallel_fwd`` on a local mesh of 8 shards on this card at
   m20 b16 (``dist_params(20)``, word 32, and ``bench_params(20, 62)``)
   and m24 b1 (``bench_params(24, 62)``): forwards equal to the flat
   'sixstep' (the lazy rec one mod q, below 4q), products to
   ``api.negacyclic_mul``, round trips exact; K4-K8 launched on at least
   8 shards at both widths (so at row0 != 0), K1-K3 launched; then
   ``dist_fwd_ntt`` m20 through a 1-rank NCCL world (``init_multihost``,
   ``all_to_all_single`` on CUDA tensors) equal to the flat form;
30. dist times: one call's device time from a CUDA graph, the D = 1, 2 and
   8 compositions (forward, inverse, product, rec forward) beside the flat
   'sixstep' at the main path's three sizes, the D = 8 forward's
   all-to-all with its copies on either side, and each shard launch (one
   of 8) beside its bound and its plain version: the kernels line's
   ``*_shard_*`` rows;
31. times: warm-up, minimum over repetitions, kernel and plain version in
   turns, beside the card's name and power limit; each kernel's bound, the
   larger of its bytes over the memory rate and its integer multiplies
   over the multiply rate.  Every kernel is timed as the lab times it (a
   CUDA graph of launches between two CUDA events, so the host's launch
   overhead stays out); the plain versions and the API calls between two
   CUDA events around one call.  K1 / K2 at every m from 10 to
   max_logn(word), and K4-K7 at every m from 15 (word 64) / 16 (word 32)
   to 24, at 2^24 words a call, beside their bounds; K4-K7 at the sizes of
   phase 6, K5 and K6 also in the transposed layout that the product keeps
   between them; K8 at the round trips' shapes; 'sixstep-rec' against the
   flat 'sixstep', forward and inverse, at every m from 16 to 24 at batch 1
   and 8, at m16-m20 batch 128 and at m17 batch 32-512, both widths (one
   API call's device time from a CUDA graph and its time in a stream of
   back-to-back calls, flat, rec, rec, flat), and the cells where rec wins
   both ways in both views beside ``api.REC_CELLS``; the handle's and the tower's
   products; the lab kernels and K1 at the lab's shape, the lab
   kernels' plain versions at batch 32, and diag_copy's and diag_moves's
   one-call PyTorch equivalents (``clone``, ``flip``) as the lab kernels
   are timed; K1's split at that shape by three probes on its design
   point (``lab.k1_split``: diag_copy, diag_math - diag_copy, diag_moves -
   diag_copy, the rest of K1), each part beside ``clone`` / ``flip`` and
   its bound; the marginal rates of the arithmetic probes
   (``lab.marginal_rates``: diag_mul at 42 and 168 steps, diag_math at m
   and 2m rounds, each also checked against its plain version): 32-bit
   multiplies a second against the bound's, butterflies a second and
   their SASS instructions a second against the card's issue rate;
   each reference-family variant's forward and product at m14
   batch 1024 beside K1's and 'auto''s (CUDA graph), K9 / K10 a stage
   beside their bounds (plain versions at batch 32), and 'radix2' /
   'radix4-u32' against 'pallas-fused' at m6-m8, batch 128 and 1024, in a
   graph and in a stream of 20 calls; K11 a launch of each contract (the
   forward's and the inverse's first pass, scaled) at m14 batch 1024, m16
   batch 128 and m20 batch 16 beside its bound (the largest of bytes over
   the memory rate, 32-bit multiplies over theirs and int8 tensor-core
   operations over the dense int8 rate) and its plain version, with
   ``torch._int_mm``'s four calls on the same int8 operands as a yardstick
   of the tensor-core part alone, and the mxu forward, inverse and product
   beside K1 (word 32, m14) and 'auto'.
32. the bench (``python -m ntt_tpu_torch bench``, subprocesses from the
   repository's root): the headline (m14, ``bench_params(14, 62)``, batch
   128, ``--budget-s 120 --reps 3``) must exit 0 with exactly one JSON
   line, no ``degraded``, a value above 0 within 10 % of 128 over the
   same call's device time from a CUDA graph in this process, and a
   ``vs_baseline``; ``--suite --only`` one body of each kernel family at
   each width (``BENCH_SUITE``; q62 and ``NttParams.generate(27, 14)``,
   the table in a temporary directory) must time every body it names;
   then, with every launch count set to 0, one call of each of those
   bodies in this process (batch 8) equals its plain version on the CPU,
   bit for bit, each body's launches are printed, and together they must
   launch K1-K11 at both widths (K10 at words 32 and 64, K11 both
   contracts).

Every phase line is followed by the wall clock the phase took, and the
times phase ends with the wall clock of every phase.
The last two lines before the final one are the nvidia-smi line and the
kernel table as JSON; the final line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, without a CUDA card or outside the
repository.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import io
import itertools
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
BATCH_CHECK = 128
BATCH_HE = 1024
CASES = ("q62", "q29")  # bench_params(14, 62) and FIXTURES[9] (q = 0x1FFC8001)
# two-pass sizes: (name, batch); m16: CKKS at N = 2^16, 128 residues;
# m20 / m24: the single-GPU sizes of BASELINE.json configs[4]
TWO_PASS = (("m16-q62", 128), ("m16-q29", 128), ("m20-q62", 16), ("m20-q29", 16),
            ("m24-q62", 1))
FIXTURES_WITHIN = tuple(range(15))  # m 8-15: 'auto' is pallas-fused (K1 / K2)
FIXTURES_BEYOND = (15, 16, 17, 18)
BATCH_EVERY_M = 3  # K1 / K2 at every m: a small odd batch
LARGE_M = 21  # from here the every-m sweeps of the plain six-step run batch 1

BATCH_WAVES = 500  # and at m14 more polynomials than one wave of blocks
WORDS_PER_M = 1 << 24  # K1 / K2 timed at m 10-14 (15), K4-K7 at m 15 (16)-24, at
# this many words a call
TWO_PASS_FIRST_M = {64: 15, 32: 16}  # K4-K7 timed at every m from the first beyond K1
TWO_PASS_LAST_M = 24
BATCH_TWO_PASS_WAVES = 300  # K4-K7 at m16: more polynomials than one wave of blocks
REC_FIRST_M, REC_LAST_M = 2, 24  # K8 and 'sixstep-rec' held against plain at every m
BATCH_REC_WAVES = 128  # K8 also at m16: more words than one wave of blocks
REC_ROUND_TRIPS = ((64, 24), (32, 23))  # (word, m) of the rec path's round trips, batch 1
REC_TIMED_M = range(16, 25)  # rec against flat at batch 1 and 8, and 128 up to m20
REC_TIMED_BATCH128_LAST_M = 20
REC_TIMED_M17_BATCHES = (1, 8, 32, 64, 128, 256, 512)  # where K4's tiles are slowest
TOWER_BITS = (30, 30, 30)  # the three-prime RNS tower of BASELINE.json configs[2]
# The reference-family variants (K9 / K10; 'radix4x4' on K1 / K2 / K4-K7), each
# at the widths it takes: (variant, q bits); 30 and 29 bits on the int32 rep,
# where the word-64 variants compute on an int64 copy.
FAMILY = (("radix2", 62), ("radix2", 30), ("radix2-u32", 29), ("seal", 62), ("hexl", 62),
          ("r2-16", 62), ("radix4", 60), ("radix4", 29), ("radix4-w56", 52), ("radix4-u32", 27),
          ("r4r2", 60), ("r4r2", 27), ("radix4-vec", 60), ("radix4-vec-unordered", 60),
          ("radix4x4", 62), ("radix4x4", 29))
FAMILY_LAST_M = 16  # every m from a variant's least up to here, batch 3
FAMILY_LARGE = ((20, 2), (24, 1))  # (m, batch), the word-64 widths
# The HE product of each variant at its widest q, m14 batch 1024: (variant, q
# bits, or "fixture9" for FIXTURES[9]); the word-64 radix-4 variants take q
# below 2^60 (api.R4_MAX_Q_BITS)
FAMILY_HE = (("radix2", 62), ("seal", 62), ("hexl", 62), ("r2-16", 62), ("radix4x4", 62),
             ("radix4", 60), ("radix4-vec", 60), ("radix4-vec-unordered", 60), ("r4r2", 60),
             ("radix4-w56", 52), ("radix2-u32", "fixture9"), ("radix4-u32", 27), ("r4r2", 27))
# The Solinas slice (the NTT_MULMOD=solinas switch): the K9 / K10 variants
# held against their plain versions, (variant, q bits of find_solinas_ntt_prime,
# m), batch BATCH_HE; and one stage of each K9 / K10 Solinas entry point,
# (entry point, q bits, m, batch, lt), at 2^24 words
SOLINAS_FAMILY = (("radix2", 62, 14), ("seal", 62, 14), ("hexl", 62, 14), ("r2-16", 62, 14),
                  ("radix4", 60, 14), ("radix4-vec", 60, 14), ("radix4-vec-unordered", 60, 14),
                  ("r4r2", 60, 14), ("radix2-u32", 27, 10), ("radix4-u32", 27, 10),
                  ("r4r2", 27, 10))
SOLINAS_STAGES = (("r2_stage_solinas_u64", 62, 14, 1024, 6),
                  ("r4_stage_solinas_u64", 60, 14, 1024, 6),
                  ("r2_stage_solinas_u32", 27, 10, 1 << 14, 4),
                  ("r4_stage_solinas_u32", 27, 10, 1 << 14, 4))
# The Solinas product alone (pointwise.solinas_mul): tests/test_torch_solinas.py's
# q of each form, (q, t bound in units of q of the lazy set or None, word), and
# SOLINAS_RANDOM_PAIRS more pairs a q over the whole word
SOLINAS_PRODUCTS = (((1 << 62) - (1 << 16) + 1, 4, 64), ((1 << 61) - (1 << 26) + 1, 8, 64),
                    ((1 << 60) - (1 << 18) + 1, 8, 64), ((1 << 51) - (1 << 17) + 1, 8, 64),
                    ((1 << 29) - (1 << 9) + 1, 8, 32), ((1 << 27) - (1 << 11) + 1, 8, 32),
                    ((1 << 33) - (1 << 15) + 1, None, 64), ((1 << 29) - (1 << 13) + 1, None, 32))
SOLINAS_RANDOM_PAIRS = 1 << 22
FAMILY_SMALL_M = (6, 7, 8)  # radix2 and radix4-u32 against pallas-fused, for 'auto'
FAMILY_SMALL_BATCHES = (128, 1024)
STAGE_KERNELS = ("r2_stage_u32", "r2_stage_u64", "r4_stage_u32", "r4_stage_u64",
                 "r4_stage_w56")
# The mxu slice: K11 against its plain version at every m from 1 to MXU_LAST_M
# (batch 2^(MXU_WORDS_LOG - m)) and at m24 batch 1, at the widest 28-bit
# fixture q (FIXTURES[8]) and at a 17-bit one; the variant through the API at
# the same m (batch 3, 1 at m24); its product, and the times, at these
# (m, batch): q = 0xfff0001 where 2N divides q - 1 (m <= 15), the largest
# 28-bit NTT prime of N beyond.
MXU_QS = (0xFFF0001, 0x10001)
MXU_LAST_M, MXU_WORDS_LOG = 20, 20
MXU_TIMED = ((14, BATCH_HE), (16, 128), (20, 16))
LIMB_KERNELS = ("limb_matmul_left", "limb_matmul_right")
# The dist slice: the shards of its main path (a local mesh on this card), the
# shard counts whose every row0 the kernel checks run, and the compositions timed
DIST_SHARDS = 8
DIST_CHECK_SHARDS = (2, 8)
DIST_TIMED_SHARDS = (1, 2, 8)
CSRC = "ntt_tpu_torch/csrc/"
LAB = "tools/pallas_lab.py:"
LAB_TRANSFORMS = ("fwd_fused_v2_r2", "fwd_fused_v2_r4", "fwd_fused_v3")
PROBES = ("diag_copy", "diag_mul", "diag_math", "diag_moves")
LAB_BATCH_CHECK = 32
LAB_EVERY_M_BATCHES = (1, 3, 133)  # diag_copy / diag_moves / diag_mul at every m K1 serves
LAB_EVERY_M_BATCH = 3  # L1 / L2 at every m K1 serves: odd, so a stray block index shows
SOURCES = {"fwd_fused": CSRC + "ntt_fused.cu", "inv_fused": CSRC + "ntt_fused.cu",
           "mul_mod": CSRC + "pointwise.cu", "fwd_cols": CSRC + "ntt_sixstep.cu",
           "fwd_rows": CSRC + "ntt_sixstep.cu", "inv_rows": CSRC + "ntt_sixstep.cu",
           "inv_cols": CSRC + "ntt_sixstep.cu", "twist_mul": CSRC + "twist.cu",
           "r2_stage": CSRC + "r2_stage.cu", "r4_stage": CSRC + "r4_stage.cu",
           "limb_matmul": CSRC + "mxu.cu",
           **{k: CSRC + "ntt_lab.cu" for k in LAB_TRANSFORMS},
           **{k: CSRC + "probes.cu" for k in PROBES}}
REPLACES = {"fwd_fused": "ntt_tpu/kernels/pallas_fused.py:230",
            "inv_fused": "ntt_tpu/kernels/pallas_fused.py:257",
            "mul_mod": "ntt_tpu/api.py:1517",
            "fwd_cols": "ntt_tpu/kernels/sixstep.py:259",
            "fwd_rows": "ntt_tpu/kernels/sixstep.py:294",
            "inv_rows": "ntt_tpu/kernels/pallas_fused.py:286",
            "inv_cols": "ntt_tpu/kernels/pallas_fused.py:307",
            "twist_mul": "ntt_tpu/kernels/sixstep.py:465",
            "r2_stage": "ntt_tpu/kernels/radix2.py:65",
            "r4_stage": "ntt_tpu/kernels/radix4.py:95",
            "limb_matmul": "ntt_tpu/kernels/mxu.py:120",
            "fwd_fused_v2_r2": LAB + "127", "fwd_fused_v2_r4": LAB + "127",
            "fwd_fused_v3": LAB + "326", "diag_copy": LAB + "444", "diag_mul": LAB + "402",
            "diag_math": LAB + "455", "diag_moves": LAB + "479"}
# The card's rates for the bound (NVIDIA H100 SXM data sheet, 700 W): HBM3 at
# 3.35 TB/s; 67 TFLOP/s of float32 are 128 fused multiply-adds per SM per
# clock, and Hopper issues 32-bit integer multiply-adds at half that (CUDA
# C++ Programming Guide, arithmetic instruction throughput): 67e12 / 4.
HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_S = 67e12 / 4
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core operations (the same data sheet)
# warp instructions a second the H100 SXM can issue: one a clock on each of
# the 4 schedulers of its 132 SMs at the 1.98 GHz maximum SM clock
WARP_ISSUE_PER_S = 132 * 4 * 1.98e9
# 32-bit multiplies of one Shoup product (hi(w_con*t), w*t, Q*q): one each at
# word 32; at word 64 a 64x64 high half takes four partial products and each
# low half three.  mul_mod: the full product, then folds (pointwise.cu).
SHOUP_MULS = {32: 3, 64: 10}
# 32-bit multiplies of one Solinas product (the NTT_MULMOD=solinas switch) at
# each word: counted from the SASS of its butterfly (ntt_tpu_torch.sass) in
# the build phase of each run
SOLINAS_MULS: dict[int, int] = {}
MUL_MOD_MULS = {32: 6, 64: 34}
N_MULTS = 42  # the multiplies of diag_mul on each 32-bit half (probes.N_MULTS)
# K11's epilogue a word: six Shoup products of the Horner chain, Barrett's two
# multiplies, the Shoup product by the scale
LIMB_EPILOGUE_MULS = 6 * SHOUP_MULS[32] + 2 + SHOUP_MULS[32]
# the bench phase: the headline run's arguments (m14, bench_params(14, 62),
# batch 128 by default), and one suite body of each kernel family at each
# width (by q_bits): K1 pallas, K2 inv-radix4x4, K3-K7 he-ctmul, K4 / K8 / K1
# sixstep-rec, K9 radix2, K10 radix4 (words 32 and 64), K11 mxu
BENCH_ARGS = ("--budget-s", "120", "--reps", "3")
BENCH_SUITE = {62: ("pallas-u64", "inv-radix4x4-u64", "he-ctmul-u64", "sixstep-rec-u64",
                    "radix2-u64"),
               27: ("pallas-u32", "inv-radix4x4-u32", "he-ctmul-u32", "sixstep-rec-u32",
                    "radix2-u32", "radix4-u32", "radix4-u64", "mxu")}
BENCH_CHECK_BATCH = 8  # the suite bodies against their plain versions on the CPU
BENCH_TOLERANCE = 0.10  # the bench's value against the in-process graph time


def launch_counts(launches, kernels, widths=("u32", "u64")) -> dict[str, int]:
    """{<kernel>_<width>: launches} of each kernel at each width, read from
    the launch registry ``launches`` (``ntt_tpu_torch.trace.LAUNCHES``); 0
    where none ran."""
    return {f"{k}_{w}": launches[f"{k}_{w}"] for k in kernels for w in widths}


def limb_launches(launches) -> dict[str, int]:
    """K11's launches by contract, ``limb_matmul_<contract>``, the scaled
    launcher's counted in its contract's."""
    return {f"limb_matmul_{c}": launches[f"limb_matmul_{c}"] + launches[f"limb_matmul_{c}_scaled"]
            for c in ("left", "right")}


def every_m_batch(m: int) -> int:
    """The sweeps' batch at m: BATCH_EVERY_M, 1 from LARGE_M up (the plain
    versions they are held against take most of the script's time there)."""
    return 1 if m >= LARGE_M else BATCH_EVERY_M


def kernel_work(kernel: str, m: int, n1_log: int, batch: int, word: int,
                solinas: bool = False, parts: int = 1):
    """(bytes, 32-bit multiplies) one launch must move and do: each input
    read once (the twiddle entries it uses included), each output written
    once.  The lab's transforms do K1's work; diag_math runs m rounds of
    butterflies on N/2 pairs, as the lab calls it; twist_mul (n1_log the
    rec split) reads its four tables, (N1, HI) and (N1, LO) words, once
    and does two Shoup products a word.  For the stage kernels n1_log is
    the stage's lt: r2_stage reads one twiddle pair a group of its
    N / 2^(lt+1) groups and does one Shoup product a butterfly; r4_stage
    reads five pairs a group of its N / 2^(lt+2) groups and does one Shoup
    product and two dual ones (each as many multiplies as two products) a
    group of four words.  limb_matmul (n1_log: log2 K of its contract, K11
    with the scale, as in each transform's first pass) reads and writes each
    word once, reads its K x K limb matrix (4 bytes an entry) and the
    (N1, N2) scale with its constants (8 bytes an entry), does 32 K int8
    tensor-core operations a word (16 limb products of a K-deep dot product,
    2 operations a term) and the epilogue's 32-bit multiplies; its entry is
    (bytes, multiplies, int8 operations).  With solinas, the work of the
    kernel's Solinas instantiation: a twiddle entry of a single product is
    one word (no Shoup constant), each single product SOLINAS_MULS[word]
    multiplies; the fused final stage's second product and r4_stage's dual
    products stay Shoup.  With parts, a launch on a shard of 1 / parts of
    each polynomial (the distributed six-step's): 1 / parts of the words,
    of the butterflies and of the row twiddles and twist tables (a row
    shard's rows), and all N1 column twiddles (a lane shard's columns)."""
    n, size = 1 << m, word // 8
    data = 2 * batch * n * size // parts
    shoup = SHOUP_MULS[word]
    prod = SOLINAS_MULS[word] if solinas else shoup  # a single product
    tw = 1 if solinas else 2  # words a twiddle entry of a single product
    bfly = batch * n // 2 * prod // parts  # one stage
    final2 = batch * n // 2 * shoup // parts  # the final stage's second product
    n1 = 1 << n1_log
    twist_lo = 1 << (m - n1_log + 1) // 2
    twist_hi = (n >> n1_log) // twist_lo
    fused = (data + tw * n * size, bfly * m)
    return {
        "fwd_fused": fused,
        **{k: fused for k in LAB_TRANSFORMS},
        "diag_copy": (data, 0),
        "diag_moves": (data, 0),
        "diag_mul": (data, batch * n * N_MULTS * word // 32),
        "diag_math": (data + tw * size, bfly * m),
        "inv_fused": (data + tw * n * size, bfly * m + final2),  # final stage: two
        "mul_mod": (3 * batch * n * size, batch * n * MUL_MOD_MULS[word]),
        "fwd_cols": (data + tw * n1 * size, bfly * n1_log),
        "inv_cols": (data + tw * n1 * size, bfly * n1_log + final2),
        "fwd_rows": (data + tw * (n - n1) // parts * size, bfly * (m - n1_log)),
        "inv_rows": (data + tw * (n - n1) // parts * size, bfly * (m - n1_log)),
        "twist_mul": (data + tw * n1 // parts * (twist_hi + twist_lo) * size,
                      2 * batch * n * prod // parts),
        "r2_stage": (data + tw * (n >> (n1_log + 1)) * size, bfly),
        "r4_stage": (data + (8 + tw) * (n >> (n1_log + 2)) * size,
                     batch * n // 4 * (prod + 4 * shoup)),
        "limb_matmul": (data + 4 * n1 * n1 + 8 * n, batch * n * LIMB_EPILOGUE_MULS,
                        32 * n1 * batch * n),
    }[kernel]


def bound(nbytes: int, muls: int, int8_ops: int = 0) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take, the
    largest of the bytes over the memory rate, the 32-bit multiplies over
    their rate and the int8 tensor-core operations over theirs."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(muls / INT_MULS_PER_S, int8_ops / INT8_OPS_PER_S) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


class PhaseClock:
    """The script's phases and the host clock at the start of each."""

    def __init__(self):
        self.starts: list[tuple[str, float]] = []

    def phase(self, name: str) -> None:
        """Start a phase: print the wall clock the previous one took."""
        now = time.perf_counter()
        if self.starts:
            print(f"  ({now - self.starts[-1][1]:.1f} s wall clock)", flush=True)
        self.starts.append((name, now))
        print(f"== {name}", flush=True)

    def seconds(self) -> dict[str, float]:
        """Seconds of wall clock each phase took, up to now."""
        ends = [t for _, t in self.starts[1:]] + [time.perf_counter()]
        return {name: round(end - start, 1) for (name, start), end in zip(self.starts, ends)}


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Minimum over reps of one call's time between two CUDA events."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def in_turns(torch, kernel, plain, reps_k: int, reps_p: int) -> tuple[float, float]:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain, reps_p)
    k1 = cuda_ms(torch, kernel, reps_k)
    k2 = cuda_ms(torch, kernel, reps_k)
    p2 = cuda_ms(torch, plain, reps_p)
    return min(k1, k2), min(p1, p2)


def kernel_in_turns(torch, lab, kernel, plain, reps_p: int) -> tuple[float, float]:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain: the
    kernel's device time from a CUDA graph of launches (lab.cuda_us; one
    call between two events would also time the host's enqueue, as long as
    a short kernel), the plain version's between two CUDA events."""
    p1 = cuda_ms(torch, plain, reps_p)
    k_ms = min(lab.cuda_us(lambda _: kernel(), None, 3, lab.INNER) for _ in range(2)) / 1e3
    return k_ms, min(p1, cuda_ms(torch, plain, reps_p))


def bitrev(j: int, bits: int) -> int:
    return int(format(j, f"0{bits}b")[::-1], 2)


def direct_ntt_at(row, j: int, p) -> int:
    """Output j of the negacyclic NTT by its definition:
    sum_i a_i * psi^(i * (2 * bitrev(j) + 1)) mod q."""
    base = pow(p.w, 2 * bitrev(j, p.m) + 1, p.q)
    acc, cur = 0, 1
    for x in row:
        acc += int(x) * cur
        cur = cur * base % p.q
    return acc % p.q


def schoolbook_at(a, b, k: int, p) -> int:
    """Coefficient k of a * b in Z_q[X]/(X^N + 1), by the definition."""
    n = p.n
    acc = sum(int(a[i]) * int(b[k - i]) for i in range(k + 1))
    acc -= sum(int(a[i]) * int(b[n + k - i]) for i in range(k + 1, n))
    return acc % p.q


def lazy_operands(np, q: int, t_bound: int, n: int = 4000):
    """tests/test_torch_solinas.py's operands(): random w < q, t < t_bound,
    and the extremes of both ranges."""
    rng = np.random.default_rng(q % 1000)
    w = rng.integers(0, q, size=n, dtype=np.uint64)
    t = rng.integers(0, t_bound, size=n, dtype=np.uint64)
    we = np.array([0, 1, q - 1, q - 2, 1, q - 1], dtype=np.uint64)
    te = np.array([0, t_bound - 1, t_bound - 1, 1, t_bound - 2, 0], dtype=np.uint64)
    return np.concatenate([we, w]), np.concatenate([te, t])


def full_range_operands(np, q: int, word: int, n: int = 512):
    """tests/test_torch_solinas.py's full_range_operands(): n pairs uniform
    over the whole word, and every pair of the edges 0 and 2^word - 1."""
    rng = np.random.default_rng(q % 997)
    top = (1 << word) - 1
    w, t = rng.integers(0, top, size=(2, n), dtype=np.uint64, endpoint=True)
    edges = np.array([0, top], dtype=np.uint64)
    return np.concatenate([np.repeat(edges, 2), w]), np.concatenate([np.tile(edges, 2), t])


def max_abs_err(np, got, want) -> int:
    """Largest |got - want| over two uint64 arrays."""
    return int(np.where(got > want, got - want, want - got).max()) if got.size else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    seed = args.seed

    import numpy as np
    import torch

    clock = PhaseClock()
    phase = clock.phase
    phase("device")
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if not (ROOT / "ntt_tpu_torch" / "csrc").is_dir():
        print(f"ntt_tpu_torch/ not found beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from ntt_tpu_torch import (FIXTURES, NttParams, api, bench, bench_params, code_cmp, lab,
                               native, rns, sass, trace)
    from ntt_tpu_torch import __main__ as cli
    from ntt_tpu_torch import modmath as mm
    from ntt_tpu_torch.kernels import (fused, fused_lab, mxu, pointwise, probes, radix2, radix4,
                                       rec, sixstep, twopass)
    from ntt_tpu_torch.examples import he_demo
    from ntt_tpu_torch.kernels.elems import pick_ops
    from ntt_tpu_torch.params import dist_params, find_solinas_ntt_prime
    from ntt_tpu_torch.plan import get_plan

    launches_of = trace.LAUNCHES  # the one launch registry, keyed by launcher name
    transform_kernels = ("fwd_fused", "inv_fused", "mul_mod", *twopass.KERNELS, "twist_mul")

    def shoup_launches() -> dict[str, int]:
        """The Shoup launchers of the main path and the variant families at
        each width (K10 also at word 56), and K11's launches by contract."""
        return {**launch_counts(launches_of, transform_kernels + ("r2_stage", "r4_stage")),
                **launch_counts(launches_of, ("r4_stage",), ("w56",)),
                **limb_launches(launches_of)}

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = lab.card(dev)
    print(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{torch.cuda.device_count()} card(s); nvidia-smi: {smi}", flush=True)

    phase("build")
    res = native.build()
    native.lib()
    print(f"library {res.path.name}: nvcc {res.seconds:.1f} s"
          + (" (already built)" if not res.log else ""), flush=True)
    for line in res.log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill", "wgmma")):
            print("  ptxas:", line.strip())
    lab_reports = {k: v for k, v in code_cmp.ptxas_reports(res.log).items()
                   if any(n in k for n in ("fwd_v2_kernel", "fwd_v3_kernel", "diag_"))}
    lab_names = code_cmp.demangle(sorted(lab_reports)) if lab_reports else {}
    for k in sorted(lab_reports, key=lab_names.get):
        print(f"  lab kernel {lab_names[k]}: {lab_reports[k]}", flush=True)
    print(f"  K11's wgmma body takes dynamic shared memory, not in ptxas's report: "
          + ", ".join(f"{mxu.wgmma_smem_bytes(1 << k)} bytes at K = {1 << k}"
                      for k in range(7, mxu.MAX_K_LOG + 1)), flush=True)
    t0 = time.perf_counter()
    bfly_sass = sass.butterfly_counts()
    for w in (32, 64):
        SOLINAS_MULS[w] = bfly_sass[f"fwd_bfly_solinas_u{w}"]["multiplies"]
    print(f"  SASS of one butterfly ({time.perf_counter() - t0:.1f} s): " + "; ".join(
        f"{k} {v['instructions']} instructions, {v['multiplies']} multiplies"
        for k, v in bfly_sass.items()), flush=True)
    print(f"  32-bit multiplies of one single product: Solinas {SOLINAS_MULS} (SASS), Shoup "
          f"{SHOUP_MULS} (by hand)", flush=True)
    # diag_mul's step loop: one multiply a 32-bit half of the group, at every
    # group size (2-16 words), so no chain folded; diag_math's round loop:
    # its 8 butterflies
    probe_sass = sass.probe_loops()
    for w in (32, 64):
        halves = 16 * w // 32
        got = probe_sass[f"diag_mul_u{w}"]
        if got["multiplies"] != halves or set(got["loops"]) != {halves >> s for s in range(4)}:
            raise AssertionError(f"diag_mul_u{w}: step loops of {got['loops']} multiplies, "
                                 f"want one a half of 2-16 words ({halves} at 16)")
    print("  SASS of the probes' innermost loops at 16 words a thread: " + "; ".join(
        f"{k} {v['instructions']} instructions, {v['multiplies']} multiplies"
        + (f" ({v['instructions'] / 8:.1f} a butterfly)" if "math" in k else
           f" a step of the {N_MULTS}")
        for k, v in probe_sass.items()), flush=True)

    params = {"q62": bench_params(14, 62), "q29": FIXTURES[9]}
    rng = np.random.default_rng(args.seed)
    errs: dict[str, int] = {}

    def rand(p, batch, hi=None):
        host = rng.integers(0, hi or p.q, size=(batch, p.n), dtype=np.uint64)
        return mm.from_host(host, p.q, dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def rand_dev(p, batch, lazy=False):
        """Values below q (with lazy, below 4q: plus 0-3 q, wrapping as the
        unsigned words do), drawn on the card: no host copy of large inputs."""
        shape, dtype = (batch, p.n), mm.dtype_for(p.q)
        x = torch.randint(0, p.q, shape, generator=gen, device=dev, dtype=dtype)
        if lazy:
            x += torch.randint(0, 4, shape, generator=gen, device=dev, dtype=dtype) * mm.s64(p.q)
        return x

    def check_ntt_rows(p, a, f, lazy, what):
        """Two rows of a forward output (strict f, lazy mod q) at sampled
        outputs against the NTT by its definition."""
        torch.cuda.synchronize()
        ha, hf, hl = (mm.to_host(t[:2]) for t in (a, f, lazy))
        js = sorted({0, 1, p.n // 2, p.n - 1, *rng.integers(0, p.n, 4).tolist()})
        for r in range(min(2, len(ha))):
            for j in js:
                want = direct_ntt_at(ha[r], j, p)
                if int(hf[r, j]) != want or int(hl[r, j]) % p.q != want:
                    raise AssertionError(f"{what} row {r} output {j}: NTT by definition "
                                         f"gives {want}, the kernel {int(hf[r, j])}")
        return js

    def check_product_rows(p, x, y, prod, what):
        """Two rows of a product at sampled coefficients against the
        schoolbook convolution."""
        hx, hy, hp = (mm.to_host(t[:2]) for t in (x, y, prod))
        ks = sorted({0, 1, p.n - 1, *rng.integers(0, p.n, 3).tolist()})
        for r in range(2):
            for k in ks:
                if int(hp[r, k]) != schoolbook_at(hx[r], hy[r], k, p):
                    raise AssertionError(f"{what} row {r} coeff {k}: product differs "
                                         "from the schoolbook convolution")
        return ks

    def note(name, got, want, what, quiet=False):
        if not torch.equal(got, want):
            err = max_abs_err(np, mm.to_host(got), mm.to_host(want))
            raise AssertionError(f"{what}: kernel differs from the plain version "
                                 f"(max abs err {err})")
        errs[name] = errs.get(name, 0)  # equal: no error
        if not quiet:
            print(f"  {what}: equal to plain ({tuple(got.shape)})", flush=True)

    def check_fixtures(inputs, fwd, back):
        """Reference fixtures through 'auto': the forward equal to the plain
        path and, at sampled outputs of two rows, to the NTT by definition;
        the round trip exact."""
        for i, a in inputs.items():
            p = FIXTURES[i]
            plan, ops = get_plan(p), pick_ops(p.q)
            tabs = plan.device_tables(dev)
            if not torch.equal(fwd[i], sixstep.fwd_sixstep(a, ops, tabs.w, tabs.w_con, p.q)):
                raise AssertionError(f"fixture {i}: fwd_ntt differs from the plain path")
            if not torch.equal(back[i], a):
                raise AssertionError(f"fixture {i}: inv_ntt(fwd_ntt(a)) != a")
            js = check_ntt_rows(p, a, fwd[i], fwd[i], f"fixture {i}")
            print(f"  fixture {i} (m {p.m}, q {p.q:#x}): fwd_ntt equals the plain path and, "
                  f"at outputs {js} of two rows, the NTT by definition; round trip exact",
                  flush=True)

    def wide_inv(p, plan, f):
        """K2 launched directly with a lazy final-stage constant in [q, 2q),
        whose Shoup constant is one bit wider than the word (no params give
        one: tmp = n_inv * w_inv[1] lands below q), and its plain version."""
        ops, tabs, inv_c = pick_ops(p.q), plan.device_tables(dev), plan.inv_consts
        tmp_w = p.q + p.q // 3
        con_w = (tmp_w << plan.word) // p.q
        out = torch.empty_like(f)
        native.launch(f"inv_fused_u{plan.word}", f.data_ptr(), out.data_ptr(),
                      tabs.w_inv.data_ptr(), tabs.w_inv_con.data_ptr(), p.q, inv_c[0],
                      inv_c[1], tmp_w, con_w & ((1 << plan.word) - 1), con_w >> plan.word,
                      f.shape[0], p.m, native.stream(dev))
        return out, sixstep.inv_sixstep(f, ops, tabs.w_inv, tabs.w_inv_con, inv_c[0],
                                        inv_c[1], tmp_w, con_w, p.q)

    def wide_inv_cols(p, plan, r, n1):
        """K7 launched directly with the same wide final-stage constant, at
        the tile its wrapper takes, and its plain version."""
        ops, tabs = pick_ops(p.q), plan.device_tables(dev)
        n_inv, n_inv_con = plan.inv_consts[:2]
        tmp_w = p.q + p.q // 3
        con_w = (tmp_w << plan.word) // p.q
        out = torch.empty_like(r)
        tc = twopass.round_tile_log(n1, p.m - n1, plan.word, rows=False)
        native.launch(f"inv_cols_u{plan.word}", r.data_ptr(), out.data_ptr(),
                      tabs.w_inv.data_ptr(), tabs.w_inv_con.data_ptr(), p.q, n_inv,
                      n_inv_con, tmp_w, con_w & ((1 << plan.word) - 1), con_w >> plan.word,
                      r.shape[0], n1, p.m - n1, tc, native.stream(dev))
        return out, sixstep.inv_cols(r, ops, tabs.w_inv, tabs.w_inv_con, n_inv, n_inv_con,
                                     tmp_w, con_w, p.q, n1)

    phase(f"kernel vs plain, batch {BATCH_CHECK}")
    for case in CASES:
        p = params[case]
        plan, ops = get_plan(p), pick_ops(p.q)
        tabs = plan.device_tables(dev)
        inv_c = plan.inv_consts
        word = f"u{plan.word}"
        a, b = rand(p, BATCH_CHECK), rand(p, BATCH_CHECK)
        k1 = fused.fwd_fused(a, plan, strict=True)
        note(f"fwd_fused_{word}", k1, sixstep.fwd_sixstep(a, ops, tabs.w, tabs.w_con, p.q),
             f"{case} K1 fwd_fused strict")
        k1l = fused.fwd_fused(a, plan, strict=False)
        note(f"fwd_fused_{word}", k1l,
             sixstep.fwd_sixstep(a, ops, tabs.w, tabs.w_con, p.q, strict=False),
             f"{case} K1 fwd_fused lazy")
        k2 = fused.inv_fused(k1, plan)
        note(f"inv_fused_{word}", k2,
             sixstep.inv_sixstep(k1, ops, tabs.w_inv, tabs.w_inv_con, *inv_c, p.q),
             f"{case} K2 inv_fused")
        if not torch.equal(k2, a):
            raise AssertionError(f"{case}: inv_fused(fwd_fused(a)) != a")
        note(f"inv_fused_{word}", *wide_inv(p, plan, k1),
             f"{case} K2 inv_fused with a {plan.word + 1}-bit final constant")
        k3 = pointwise.mul_mod(a, b, p.q)
        note(f"mul_mod_{word}", k3, ops.mul_mod(a, b, p.q), f"{case} K3 mul_mod")
        js = check_ntt_rows(p, a, k1, k1l, f"{case} K1")
        ha, hb, h3 = (mm.to_host(t[:2]) for t in (a, b, k3))
        for r in range(2):
            if any(int(x) * int(y) % p.q != int(z) for x, y, z in zip(ha[r], hb[r], h3[r])):
                raise AssertionError(f"{case} row {r}: K3 differs from Python ints")
        print(f"  {case}: two rows of K1 (strict, lazy mod q) at outputs {js} match the "
              "NTT by definition; K3 rows match Python ints; inv_fused(fwd_fused(a)) == a",
              flush=True)

    def params_at(m, word):
        """The 62-bit bench q at word 64, a 29-bit q at word 32."""
        return bench_params(m, 62) if word == 64 else NttParams.generate(29, m)

    def every_m(word):
        """(m, params) for every m K1 / K2 serve at a width."""
        for m in range(1, fused.max_logn(word) + 1):
            yield m, params_at(m, word)

    def two_pass_m(word, first=None):
        """(m, params, n1_log) for every m of the K4 / K5 sweep at a width
        (from ``first``), at the API's split."""
        for m in range(first or TWO_PASS_FIRST_M[word], TWO_PASS_LAST_M + 1):
            yield m, params_at(m, word), sixstep.word_split(1 << m, word)

    phase(f"K1 / K2 vs plain at every m they serve (batch {BATCH_EVERY_M}), and at m14 "
          f"batch {BATCH_WAVES}")
    for word in (64, 32):
        done = []
        for m, p in every_m(word):
            plan, ops = get_plan(p), pick_ops(p.q)
            tabs = plan.device_tables(dev)
            for batch in (BATCH_EVERY_M, BATCH_WAVES) if m == 14 else (BATCH_EVERY_M,):
                a = rand(p, batch, hi=4 * p.q)
                tag = f"w{word} m{m} b{batch}"
                for strict in (True, False):
                    note(f"fwd_fused_u{word}", fused.fwd_fused(a, plan, strict),
                         sixstep.fwd_sixstep(a, ops, tabs.w, tabs.w_con, p.q, strict=strict),
                         f"{tag} K1 {'strict' if strict else 'lazy'}, input < 4q", quiet=True)
                f = sixstep.fwd_sixstep(a, ops, tabs.w, tabs.w_con, p.q)
                k2 = fused.inv_fused(f, plan)
                note(f"inv_fused_u{word}", k2,
                     sixstep.inv_sixstep(f, ops, tabs.w_inv, tabs.w_inv_con, *plan.inv_consts,
                                         p.q), f"{tag} K2", quiet=True)
                if m in (3, 14):
                    note(f"inv_fused_u{word}", *wide_inv(p, plan, f),
                         f"{tag} K2 with a {word + 1}-bit final constant", quiet=True)
                done.append(tag)
                del a, f, k2
        print(f"  w{word}: K1 (strict, lazy, inputs < 4q) and K2 equal to plain at "
              f"{', '.join(done)}; K2 with a {word + 1}-bit final constant at m3 and m14",
              flush=True)

    phase(f"main path: negacyclic_mul at batch {BATCH_HE}, round trip at batch {BATCH_CHECK}, "
          f"fixtures {FIXTURES_WITHIN[0]}-{FIXTURES_WITHIN[-1]} through 'auto'")
    he = {case: (rand(params[case], BATCH_HE), rand(params[case], BATCH_HE)) for case in CASES}
    rt = {case: rand(params[case], BATCH_CHECK) for case in CASES}
    fx = {i: rand(FIXTURES[i], 4) for i in FIXTURES_WITHIN}
    torch.cuda.synchronize()
    launches_of.clear()
    prod, back = {}, {}
    for case in CASES:
        p = params[case]
        prod[case] = api.negacyclic_mul(*he[case], p)
        back[case] = api.inv_ntt(api.fwd_ntt(rt[case], p), p)
    fwd_fx = {i: api.fwd_ntt(a, FIXTURES[i]) for i, a in fx.items()}
    back_fx = {i: api.inv_ntt(f, FIXTURES[i]) for i, f in fwd_fx.items()}
    torch.cuda.synchronize()
    launches = launch_counts(launches_of, ("fwd_fused", "inv_fused", "mul_mod"))
    print(f"  launch counts of the main path: {launches}", flush=True)
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels never launched by the main path: {idle}")

    def plain_product(p, x, y):
        plan, ops = get_plan(p), pick_ops(p.q)
        tabs = plan.device_tables(dev)
        fx = sixstep.fwd_sixstep(x, ops, tabs.w, tabs.w_con, p.q)
        fy = sixstep.fwd_sixstep(y, ops, tabs.w, tabs.w_con, p.q)
        return sixstep.inv_sixstep(ops.mul_mod(fx, fy, p.q), ops, tabs.w_inv,
                                   tabs.w_inv_con, *plan.inv_consts, p.q)

    for case in CASES:
        p = params[case]
        x, y = he[case]
        if not torch.equal(back[case], rt[case]):
            raise AssertionError(f"{case}: inv_ntt(fwd_ntt(a)) != a")
        want = plain_product(p, x, y)
        if not torch.equal(prod[case], want):
            raise AssertionError(f"{case}: negacyclic_mul differs from the plain path")
        ks = check_product_rows(p, x, y, prod[case], case)
        print(f"  {case}: negacyclic_mul {tuple(x.shape)} equals the plain path and, at "
              f"coefficients {ks} of two rows, the schoolbook product; round trip "
              f"{tuple(rt[case].shape)} exact", flush=True)
        del want
    check_fixtures(fx, fwd_fx, back_fx)
    del fx, fwd_fx, back_fx

    tp_params = {"m16-q62": bench_params(16, 62), "m16-q29": NttParams.generate(29, 16),
                 "m20-q62": bench_params(20, 62), "m20-q29": NttParams.generate(29, 20),
                 "m24-q62": bench_params(24, 62)}

    def two_pass_ops(size):
        p = tp_params[size]
        plan = get_plan(p)
        return p, plan, pick_ops(p.q), plan.device_tables(dev), \
            sixstep.word_split(p.n, plan.word), f"u{plan.word}"

    phase("two-pass kernels vs plain: " + ", ".join(f"{s} batch {b}" for s, b in TWO_PASS))
    for size, batch in TWO_PASS:
        p, plan, ops, tabs, n1, word = two_pass_ops(size)
        tag = f"{size} (n1_log {n1})"
        a = rand(p, batch)
        k4 = twopass.fwd_cols(a, plan, n1)
        note(f"fwd_cols_{word}", k4, sixstep.fwd_cols(a, ops, tabs.w, tabs.w_con, p.q, n1),
             f"{tag} K4 fwd_cols")
        lazy_in = rand(p, batch, hi=4 * p.q)
        note(f"fwd_cols_{word}", twopass.fwd_cols(lazy_in, plan, n1),
             sixstep.fwd_cols(lazy_in, ops, tabs.w, tabs.w_con, p.q, n1),
             f"{tag} K4 fwd_cols on lazy input < 4q")
        del lazy_in
        k5 = {}
        for strict in (True, False):
            for keep_t in (False, True):
                k5[strict, keep_t] = twopass.fwd_rows(k4, plan, n1, strict, keep_t)
                note(f"fwd_rows_{word}", k5[strict, keep_t],
                     sixstep.fwd_rows(k4, ops, tabs.w, tabs.w_con, p.q, n1, strict, keep_t),
                     f"{tag} K5 fwd_rows {'strict' if strict else 'lazy'}"
                     f"{', kept transposed' if keep_t else ''}")
        k6 = twopass.inv_rows(k5[True, False], plan, n1)
        note(f"inv_rows_{word}", k6, sixstep.inv_rows(k5[True, False], ops, tabs.w_inv,
                                                      tabs.w_inv_con, p.q, n1),
             f"{tag} K6 inv_rows")
        k6t = twopass.inv_rows(k5[True, True], plan, n1, input_transposed=True)
        note(f"inv_rows_{word}", k6t, sixstep.inv_rows(k5[True, True], ops, tabs.w_inv,
                                                       tabs.w_inv_con, p.q, n1, True),
             f"{tag} K6 inv_rows from the transposed layout")
        if not torch.equal(k6, k6t):
            raise AssertionError(f"{tag}: K6 differs between the two input layouts")
        k7 = twopass.inv_cols(k6, plan, n1)
        note(f"inv_cols_{word}", k7, sixstep.inv_cols(k6, ops, tabs.w_inv, tabs.w_inv_con,
                                                      *plan.inv_consts, p.q, n1),
             f"{tag} K7 inv_cols")
        if not torch.equal(k7, a):
            raise AssertionError(f"{tag}: K7(K6(K5(K4(a)))) != a")
        # K7's branch for a final-stage constant one bit wider than the word,
        # driven directly as K2's is above
        note(f"inv_cols_{word}", *wide_inv_cols(p, plan, k6, n1),
             f"{tag} K7 inv_cols with a {plan.word + 1}-bit final constant")
        if p.m <= 17:
            js = check_ntt_rows(p, a, k5[True, False], k5[False, False], tag)
            print(f"  {tag}: two rows of K4 + K5 (strict, lazy mod q) at outputs {js} match "
                  "the NTT by definition", flush=True)
        del a, k4, k5, k6, k6t, k7
        torch.cuda.empty_cache()

    phase(f"K4-K7 vs plain at every m from 1 to {TWO_PASS_LAST_M} (batch {BATCH_EVERY_M}, 1 "
          f"from m{LARGE_M}), "
          f"and at m16 batch {BATCH_TWO_PASS_WAVES}")
    for word in (64, 32):
        done = []
        for m, p, n1 in two_pass_m(word, first=1):
            plan, ops = get_plan(p), pick_ops(p.q)
            tabs = plan.device_tables(dev)
            for batch in (BATCH_EVERY_M, BATCH_TWO_PASS_WAVES) if m == 16 else (every_m_batch(m),):
                tag = f"w{word} m{m} b{batch} (n1_log {n1})"
                a = rand(p, batch, hi=4 * p.q)
                c = sixstep.fwd_cols(a, ops, tabs.w, tabs.w_con, p.q, n1)
                note(f"fwd_cols_u{word}", twopass.fwd_cols(a, plan, n1), c,
                     f"{tag} K4 on input < 4q", quiet=True)
                f = {}
                for strict in (True, False):
                    for keep_t in (False, True):
                        f[strict, keep_t] = sixstep.fwd_rows(c, ops, tabs.w, tabs.w_con, p.q, n1,
                                                             strict, keep_t)
                        note(f"fwd_rows_u{word}", twopass.fwd_rows(c, plan, n1, strict, keep_t),
                             f[strict, keep_t], f"{tag} K5 {'strict' if strict else 'lazy'}"
                             f"{', kept transposed' if keep_t else ''}", quiet=True)
                r = sixstep.inv_rows(f[True, False], ops, tabs.w_inv, tabs.w_inv_con, p.q, n1)
                k6 = twopass.inv_rows(f[True, False], plan, n1)
                note(f"inv_rows_u{word}", k6, r, f"{tag} K6", quiet=True)
                k6t = twopass.inv_rows(f[True, True], plan, n1, input_transposed=True)
                note(f"inv_rows_u{word}", k6t,
                     sixstep.inv_rows(f[True, True], ops, tabs.w_inv, tabs.w_inv_con, p.q, n1,
                                      True), f"{tag} K6 from the transposed layout", quiet=True)
                if not torch.equal(k6, k6t):
                    raise AssertionError(f"{tag}: K6 differs between the two input layouts")
                note(f"inv_cols_u{word}", twopass.inv_cols(r, plan, n1),
                     sixstep.inv_cols(r, ops, tabs.w_inv, tabs.w_inv_con, *plan.inv_consts,
                                      p.q, n1), f"{tag} K7", quiet=True)
                note(f"inv_cols_u{word}", *wide_inv_cols(p, plan, r, n1),
                     f"{tag} K7 with a {word + 1}-bit final constant", quiet=True)
                done.append(f"m{m} b{batch}")
                del a, c, f, r, k6, k6t
            torch.cuda.empty_cache()
        print(f"  w{word}: K4 (input < 4q), K5 (strict, lazy, both layouts), K6 (both "
              f"layouts), K7 and K7 with a {word + 1}-bit final constant equal to plain at "
              f"{', '.join(done)}", flush=True)

    phase("main path beyond one block: negacyclic_mul m16 batch 128, round trips m20 "
          "batch 16 and m24 batch 1, fixtures 15-18 through 'auto'")
    he2 = {s: (rand(tp_params[s], 128), rand(tp_params[s], 128))
           for s in ("m16-q62", "m16-q29")}
    rt2 = {s: rand(tp_params[s], b) for s, b in TWO_PASS if not s.startswith("m16")}
    fx2 = {i: rand(FIXTURES[i], 4) for i in FIXTURES_BEYOND}
    torch.cuda.synchronize()
    launches_of.clear()
    prod2 = {s: api.negacyclic_mul(x, y, tp_params[s]) for s, (x, y) in he2.items()}
    back2 = {s: api.inv_ntt(api.fwd_ntt(a, tp_params[s]), tp_params[s])
             for s, a in rt2.items()}
    fwd2 = {i: api.fwd_ntt(a, FIXTURES[i]) for i, a in fx2.items()}
    back_fx = {i: api.inv_ntt(f, FIXTURES[i]) for i, f in fwd2.items()}
    torch.cuda.synchronize()
    launches2 = launch_counts(launches_of, (*twopass.KERNELS, "mul_mod"))
    print(f"  launch counts of this path: {launches2}", flush=True)
    idle = [k for k, v in launches2.items() if v == 0]
    if idle:
        raise AssertionError(f"kernels never launched by the main path: {idle}")
    if any(launch_counts(launches_of, ("fwd_fused", "inv_fused")).values()):
        raise AssertionError("the path beyond one block launched a fused kernel")
    for s, (x, y) in he2.items():
        p = tp_params[s]
        if not torch.equal(prod2[s], plain_product(p, x, y)):
            raise AssertionError(f"{s}: negacyclic_mul differs from the plain path")
        ks = check_product_rows(p, x, y, prod2[s], s)
        print(f"  {s}: negacyclic_mul {tuple(x.shape)} equals the plain path and, at "
              f"coefficients {ks} of two rows, the schoolbook product", flush=True)
    for s, a in rt2.items():
        if not torch.equal(back2[s], a):
            raise AssertionError(f"{s}: inv_ntt(fwd_ntt(a)) != a")
        print(f"  {s}: round trip {tuple(a.shape)} exact", flush=True)
    check_fixtures(fx2, fwd2, back_fx)
    del prod2, back2, fwd2, back_fx, fx2

    phase(f"K8 and sixstep-rec vs plain at every m from {REC_FIRST_M} to {REC_LAST_M} (K8 batch "
          f"{BATCH_EVERY_M} and at m16 batch {BATCH_REC_WAVES}; sixstep-rec batch {BATCH_EVERY_M}, "
          f"1 from m{LARGE_M})")
    for word in (64, 32):
        done = []
        for m in range(REC_FIRST_M, REC_LAST_M + 1):
            p = params_at(m, word)
            plan, ops = get_plan(p), pick_ops(p.q)
            l1 = sixstep.rec_split(m)
            for batch in (BATCH_EVERY_M, BATCH_REC_WAVES) if m == 16 else (BATCH_EVERY_M,):
                tag = f"w{word} m{m} b{batch} (n1_log {l1})"
                lazy_in = rand_dev(p, batch, lazy=True)
                for inverse in (False, True):
                    tw = plan.device_tables(dev).twist(l1, inverse)
                    note(f"twist_mul_u{word}", rec.twist_mul(lazy_in, plan, l1, inverse),
                         sixstep.twist_mul(lazy_in, ops, tw, p.q),
                         f"{tag} K8 {'inverse' if inverse else 'forward'} on input < 4q",
                         quiet=True)
                del lazy_in
                done.append(f"m{m} b{batch}")
            x = rand_dev(p, every_m_batch(m))
            f = {}
            for strict in (True, False):
                f[strict] = api.fwd_ntt(x, p, "sixstep-rec", lazy=not strict)
                note("sixstep-rec", f[strict], rec.plain_fwd(x, plan, strict),
                     f"w{word} m{m} sixstep-rec {'strict' if strict else 'lazy'}", quiet=True)
            if not torch.equal(f[True], api.fwd_ntt(x, p, "sixstep")):
                raise AssertionError(f"w{word} m{m}: sixstep-rec differs from the flat sixstep")
            back = api.inv_ntt(f[True], p, "sixstep-rec")
            note("sixstep-rec", back, rec.plain_inv(f[True], plan),
                 f"w{word} m{m} sixstep-rec inverse", quiet=True)
            if not torch.equal(back, x):
                raise AssertionError(f"w{word} m{m}: sixstep-rec round trip differs")
            del x, f, back
        torch.cuda.empty_cache()
        print(f"  w{word}: K8 (both twists, input < 4q) equal to plain at {', '.join(done)}; "
              f"sixstep-rec (strict, lazy, inverse; K4 / K7 at the rec split) equal to plain, "
              f"strict equal to the flat sixstep, round trip exact at every m from "
              f"{REC_FIRST_M} to {REC_LAST_M}", flush=True)

    phase("main path of the rec slice: fwd_ntt / inv_ntt through 'sixstep-rec' at "
          + ", ".join(f"w{w} m{m}" for w, m in REC_ROUND_TRIPS)
          + " batch 1 and through 'auto' at the first cell of api.REC_CELLS"
          + f", DeviceNtt.negacyclic q62 m14 batch {BATCH_HE}, DeviceRnsTower "
          f"{TOWER_BITS} m14 batch {BATCH_HE} and its big-int product at batch 1")
    rt3 = {(w, m): (params_at(m, w), rand(params_at(m, w), 1)) for w, m in REC_ROUND_TRIPS}
    (auto_w, auto_m), (auto_rows, _) = next(iter(api.REC_CELLS.items()))
    auto_p = params_at(auto_m, auto_w)
    auto_x = rand_dev(auto_p, auto_rows)
    p14 = params["q62"]
    ctx = api.DeviceNtt(p14, device=dev)
    hx = rng.integers(0, p14.q, size=(2, BATCH_HE, p14.n), dtype=np.uint64)
    hx_dev = (ctx.from_host(hx[0]), ctx.from_host(hx[1]))
    tower = rns.DeviceRnsTower(14, TOWER_BITS, device=dev)
    big_q = tower.modulus_product
    tx = [tower.encode(rng.integers(0, 1 << 62, size=(BATCH_HE, tower.n), dtype=np.uint64))
          for _ in range(2)]
    big = [np.array([int(v) % big_q for v in rng.integers(0, 1 << 40, size=tower.n,
                                                          dtype=np.uint64)], dtype=object)
           for _ in range(2)]
    tx_dev = (tower.from_host(tx[0]), tower.from_host(tx[1]))
    torch.cuda.synchronize()
    launches_of.clear()
    fwd3 = {k: api.fwd_ntt(x, p, "sixstep-rec") for k, (p, x) in rt3.items()}
    back3 = {k: api.inv_ntt(fwd3[k], rt3[k][0], "sixstep-rec") for k in rt3}
    fwd_auto = api.fwd_ntt(auto_x, auto_p)
    back_auto = api.inv_ntt(fwd_auto, auto_p)
    hprod = ctx.negacyclic(*hx_dev)
    hprod_lazy = api.DeviceNtt(p14, lazy=True, device=dev).negacyclic(*hx_dev)
    tprod = tower.negacyclic(*tx_dev)
    tbig = tower.negacyclic_mul_bigint(*big)
    torch.cuda.synchronize()
    launches4 = launch_counts(launches_of, transform_kernels)
    print(f"  launch counts of this path: {launches4}", flush=True)
    needed = [f"{k}_u{w}" for k in ("twist_mul", "fwd_cols", "inv_cols", "fwd_fused",
                                    "inv_fused", "mul_mod") for w in (64, 32)]
    idle = [k for k in needed if launches4[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched by the rec slice's path: {idle}")
    for (w, m), (p, x) in rt3.items():
        if not torch.equal(back3[w, m], x):
            raise AssertionError(f"w{w} m{m}: inv_rec(fwd_rec(a)) != a")
        if not torch.equal(fwd3[w, m], api.fwd_ntt(x, p, "sixstep")):
            raise AssertionError(f"w{w} m{m}: sixstep-rec differs from the flat sixstep")
        print(f"  w{w} m{m} q {p.q:#x}: fwd_ntt through sixstep-rec equals the flat sixstep, "
              "inv_ntt(fwd_ntt(a)) == a", flush=True)
    auto_v = api._pick(get_plan(auto_p), "auto", rows=auto_rows).name
    if auto_v != "sixstep-rec" or not torch.equal(back_auto, auto_x) or not torch.equal(
            fwd_auto, api.fwd_ntt(auto_x, auto_p, "sixstep")):
        raise AssertionError(f"w{auto_w} m{auto_m} batch {auto_rows} through 'auto' ({auto_v}): "
                             "forward differs from the flat sixstep or the round trip fails")
    print(f"  w{auto_w} m{auto_m} batch {auto_rows} through 'auto' (a cell of api.REC_CELLS, "
          f"{auto_v}): forward equals the flat sixstep, round trip exact", flush=True)
    if not torch.equal(hprod, api.negacyclic_mul(*hx_dev, p14)):
        raise AssertionError("DeviceNtt.negacyclic differs from api.negacyclic_mul")
    if not torch.equal(hprod_lazy, hprod):
        raise AssertionError("the lazy handle's product (K3 on lazy forwards) differs")
    ks = check_product_rows(p14, *hx_dev, hprod, "DeviceNtt q62 m14")
    print(f"  DeviceNtt q62 m14: negacyclic {tuple(hprod.shape)} (and the lazy handle's) equals "
          f"api.negacyclic_mul and, at coefficients {ks} of two rows, the schoolbook product",
          flush=True)
    host_tower = rns.RnsTower(14, params=tower.params, device=dev)
    if not np.array_equal(tower.to_host(tprod), host_tower.negacyclic_mul(*tx)):
        raise AssertionError("DeviceRnsTower.negacyclic differs from the host tower")
    tks = sorted({0, 1, tower.n - 1, *rng.integers(0, tower.n, 3).tolist()})
    ring = argparse.Namespace(n=tower.n, q=big_q)
    for k in tks:
        if int(tbig[k]) != schoolbook_at(*big, k, ring):
            raise AssertionError(f"tower big-int product coeff {k} differs from the schoolbook")
    print(f"  DeviceRnsTower {[hex(q) for q in tower.moduli]} m14: negacyclic {len(tprod)} x "
          f"{tuple(tprod[0].shape)} equals the host tower; the big-int product "
          f"({big_q.bit_length()}-bit Q) equals the schoolbook at coefficients {tks}", flush=True)
    del fwd3, back3, rt3, tprod, hprod, hprod_lazy, fwd_auto, back_auto, auto_x


    lab_cases = ("u32", "u64")
    lab_params = {c: lab.case_params(c, 14) for c in lab_cases}
    lab_n1 = lab.lab_split(14)
    phase(f"lab kernels vs plain: m14 batch {LAB_BATCH_CHECK}, n1_log {lab_n1} (and 4); L1 / L2 "
          f"and diag_math at every m, batch {LAB_EVERY_M_BATCH}; diag_copy / diag_moves / "
          f"diag_mul at every m, batch {LAB_EVERY_M_BATCHES}")
    for case in lab_cases:
        p = lab_params[case]
        plan = get_plan(p)
        word = f"u{plan.word}"
        a = rand(p, LAB_BATCH_CHECK, hi=4 * p.q)
        for group in (1, 2):
            for strict, keep_t in ((True, False), (False, False), (True, True)):
                what = (f"{'strict' if strict else 'lazy'}"
                        f"{', kept transposed' if keep_t else ''}")
                note(f"fwd_fused_v2_r{2 * group}_{word}",
                     fused_lab.fwd_fused_v2(a, plan, lab_n1, group, strict, keep_t),
                     fused_lab.plain(a, plan, lab_n1, strict, keep_t),
                     f"{case} L1 fwd_fused_v2 group {group} {what}")
        for strict, keep_t in ((True, False), (False, False), (True, True)):
            what = f"{'strict' if strict else 'lazy'}{', kept transposed' if keep_t else ''}"
            note(f"fwd_fused_v3_{word}", fused_lab.fwd_fused_v3(a, plan, lab_n1, strict, keep_t),
                 fused_lab.plain(a, plan, lab_n1, strict, keep_t),
                 f"{case} L2 fwd_fused_v3 {what}")
        note(f"fwd_fused_v2_r4_{word}", fused_lab.fwd_fused_v2(a, plan, 4),
             fused_lab.plain(a, plan, 4), f"{case} L1 fwd_fused_v2 group 2 at n1_log 4")
        note(f"fwd_fused_v3_{word}", fused_lab.fwd_fused_v3(a, plan, 4),
             fused_lab.plain(a, plan, 4), f"{case} L2 fwd_fused_v3 at n1_log 4")
        if not torch.equal(fused_lab.fwd_fused_v3(a, plan, lab_n1), fused.fwd_fused(a, plan)):
            raise AssertionError(f"{case}: L2 differs from K1")
        note(f"diag_copy_{word}", probes.diag_copy(a), a.clone(), f"{case} L3 diag_copy")
        note(f"diag_mul_{word}", probes.diag_mul(a), probes.plain_mul(a), f"{case} L3 diag_mul")
        note(f"diag_math_{word}", probes.diag_math(a, plan, p.m),
             probes.plain_math(a, plan, p.m), f"{case} L3 diag_math, {p.m} rounds")
        note(f"diag_math_{word}", probes.diag_math(a, plan, 0), a,
             f"{case} L3 diag_math, 0 rounds: its input")
        note(f"diag_moves_{word}", probes.diag_moves(a), a.flip(-1), f"{case} L3 diag_moves")
        del a
    # L1 (both groups) and L2 on K1's design point: every m it serves, the
    # split edges the wrappers take, strict and lazy, both layouts, batch
    # LAB_EVERY_M_BATCH, inputs below 4q (from a generator of their own)
    lab_rng = np.random.default_rng([seed, 11])

    def lab_every_m(params_of, last_m, tag):
        for m in range(1, last_m + 1):
            p = params_of(m)
            plan = get_plan(p)
            sol = mm.solinas_args(p.q, plan.word)
            if bool(sol) != mm.USE_SOLINAS:
                raise AssertionError(f"{tag} q {p.q:#x} m{m}: Solinas product {sol}")
            suffix = f"_solinas_u{plan.word}" if sol else f"_u{plan.word}"
            host = lab_rng.integers(0, 4 * p.q, size=(LAB_EVERY_M_BATCH, p.n), dtype=np.uint64)
            a = mm.from_host(host, p.q, dev)
            for n1 in sorted({1, m // 2, m - 1, m} - {0}):
                for strict, keep_t in itertools.product((True, False), (False, True)):
                    want = fused_lab.plain(a, plan, n1, strict, keep_t)
                    what = f"{tag} m{m} n1_log {n1} strict {strict} kept transposed {keep_t}"
                    for group in (1, 2):
                        note(f"fwd_fused_v2_r{2 * group}{suffix}",
                             fused_lab.fwd_fused_v2(a, plan, n1, group, strict, keep_t), want,
                             f"{what} L1 group {group}", quiet=True)
                    note(f"fwd_fused_v3{suffix}",
                         fused_lab.fwd_fused_v3(a, plan, n1, strict, keep_t), want,
                         f"{what} L2", quiet=True)
            if not torch.equal(fused_lab.fwd_fused_v3(a, plan, m // 2 or 1),
                               fused.fwd_fused(a, plan)):
                raise AssertionError(f"{tag} m{m}: L2 differs from K1")
            note(f"diag_math{suffix}", probes.diag_math(a, plan, m),
                 probes.plain_math(a, plan, m), f"{tag} m{m} diag_math, {m} rounds", quiet=True)
            note(f"diag_math{suffix}", probes.diag_math(a, plan, 0), a,
                 f"{tag} m{m} diag_math, 0 rounds: its input", quiet=True)
        print(f"  {tag}: L1 (groups 1 and 2) and L2 equal to the plain six-step at every m "
              f"from 1 to {last_m}, n1_log 1, m // 2, m - 1 and m, strict and lazy, both "
              f"layouts, batch {LAB_EVERY_M_BATCH}; L2 equal to K1; diag_math equal to plain "
              f"at m rounds and to its input at 0", flush=True)

    for case in lab_cases:
        word = 32 if case == "u32" else 64
        lab_every_m(lambda m, case=case: lab.case_params(case, m), fused.max_logn(word),
                    f"{case} (Shoup)")
    # diag_copy / diag_moves / diag_mul run K1's design point: every m it
    # serves; one block, a few, and one more than the card's 132 SMs; any word
    # pattern
    # (from a generator of their own, so later phases keep their inputs);
    # and a tensor 4 / 8 bytes off 16-byte alignment
    probe_rng = np.random.default_rng([seed, 14])
    for word, dtype in ((32, torch.int32), (64, torch.int64)):
        for m in range(1, fused.max_logn(word) + 1):
            for batch in LAB_EVERY_M_BATCHES:
                host = probe_rng.integers(-2**63, 2**63 - 1, size=(batch, 1 << m), dtype=np.int64)
                a = torch.from_numpy(host).to(dev, dtype)
                what = f"w{word} m{m} batch {batch}"
                note(f"diag_copy_u{word}", probes.diag_copy(a), a.clone(), f"{what} diag_copy",
                     quiet=True)
                note(f"diag_moves_u{word}", probes.diag_moves(a), a.flip(-1),
                     f"{what} diag_moves", quiet=True)
                note(f"diag_mul_u{word}", probes.diag_mul(a), probes.plain_mul(a),
                     f"{what} diag_mul", quiet=True)
        a = torch.from_numpy(probe_rng.integers(-2**63, 2**63 - 1, size=3 * 2**14 + 1,
                                          dtype=np.int64)).to(dev, dtype)[1:].view(3, 2**14)
        assert a.is_contiguous() and a.data_ptr() % 16 != 0
        note(f"diag_copy_u{word}", probes.diag_copy(a), a.clone(),
             f"w{word} m14 batch 3 unaligned diag_copy", quiet=True)
        note(f"diag_moves_u{word}", probes.diag_moves(a), a.flip(-1),
             f"w{word} m14 batch 3 unaligned diag_moves", quiet=True)
        note(f"diag_mul_u{word}", probes.diag_mul(a), probes.plain_mul(a),
             f"w{word} m14 batch 3 unaligned diag_mul", quiet=True)
    print(f"  diag_copy / diag_moves / diag_mul equal to clone() / flip(-1) / plain_mul at "
          f"every m from 1 to {fused.max_logn(32)} / {fused.max_logn(64)} (w32 / w64), batch "
          f"{', '.join(map(str, LAB_EVERY_M_BATCHES))}, and at m14 batch 3 unaligned",
          flush=True)

    phase("lab path: python -m ntt_tpu_torch.lab --cases both --no-time (m14 batch 512)")
    torch.cuda.synchronize()
    launches_of.clear()
    records = lab.main(["--cases", "both", "--no-time"])
    torch.cuda.synchronize()
    launches3 = launch_counts(launches_of, fused_lab.KERNELS + probes.PROBES)
    print(f"  launch counts of the lab path: {launches3}; K1 "
          f"{launch_counts(launches_of, ('fwd_fused', 'inv_fused'))}", flush=True)
    idle = [k for k, v in launches3.items() if v == 0]
    idle += [k for k in ("fwd_fused_u32", "fwd_fused_u64") if launches_of[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched by the lab path: {idle}")
    if len(records) != 2 * len(lab.CANDIDATES) or not all(r["exact"] for r in records):
        raise AssertionError(f"the lab path did not check every candidate: {records}")
    print(f"  {len(records)} candidates bit-exact (transforms against the plain six-step "
          "and K1, probes against their plain versions)", flush=True)

    def family_params(bits, m):
        """The variant phases' params: bench_params at 52 bits and up (the
        widest q of that many bits), the fixture q 0x1FFC8001 at m14 for
        "fixture9", a generated q otherwise."""
        if bits == "fixture9":
            return FIXTURES[9]
        return bench_params(m, bits) if bits >= 52 else NttParams.generate(bits, m)

    def lazy_bound(name, m):
        """The variant's lazy output bound, in units of q."""
        if name in ("radix4", "radix4-w56", "radix4-u32"):
            return 8 if m % 2 == 0 else 4
        return 8 if name.startswith("radix4-vec") else 4

    def on_dev(t):
        return torch.from_numpy(t).to(dev)

    def check_family(name, p, batch, quiet=True):
        """One variant at one size on the card: the strict and lazy forward
        and the inverse (K9 / K10, or K1 / K2 / K4-K7 for radix4x4) equal to
        the plain versions on the same CUDA tensors; the lazy output below
        its bound; the strict one equal to the six-step's after the
        layout's fix; the round trip exact."""
        v, plan = api.get_variant(name), get_plan(p)
        hi = 4 * p.q if name == "hexl" else p.q
        host = rng.integers(0, hi, size=(batch, p.n), dtype=np.uint64)
        x = mm.from_host(host, p.q, dev, wide=v.word64)
        tag = f"{name} q{p.q.bit_length()} m{p.m} b{batch}"
        f = {}
        for lazy in (False, True):
            f[lazy] = api.fwd_ntt(x, p, name, lazy=lazy)
            note(name, f[lazy], v.fwd(plan, x, lazy, plain=True),
                 f"{tag} {'lazy' if lazy else 'strict'}", quiet=quiet)
        top = int(mm.to_host(f[True]).max())
        if top >= lazy_bound(name, p.m) * p.q:
            raise AssertionError(f"{tag}: lazy output {top} not below "
                                 f"{lazy_bound(name, p.m)}q")
        if name == "hexl":
            x = mm.reduce_4q_to_q(x, p.q)
        rep = x if x.dtype == plan.dtype else x.to(plan.dtype)
        perm = on_dev(api.output_layout(name, p).perm)
        if not torch.equal(f[False][..., perm].to(plan.dtype), api.fwd_ntt(rep, p, "sixstep")):
            raise AssertionError(f"{tag}: strict forward differs from sixstep's")
        back = api.inv_ntt(f[False], p, name)
        note(name, back, v.inv(plan, f[False], plain=True), f"{tag} inverse", quiet=quiet)
        if not torch.equal(back, x):
            raise AssertionError(f"{tag}: round trip differs")

    # -- the Solinas slice: the NTT_MULMOD=solinas switch -----------------------
    # Phases 18-27 flip the port's global modmath.USE_SOLINAS (restored in a
    # finally, which re-raises) and run the Solinas instantiations of K1, K2,
    # K4-K10 at q = 2^e - 2^k + 1 (find_solinas_ntt_prime): the headline
    # 2^62 - 2^16 + 1 up to m15, 2^61 - 2^21 + 1 to m20 and 2^61 - 2^26 + 1 to
    # m25 (no 62-bit prime of the form serves m16 and up), 2^60 - 2^18 + 1 for
    # the radix-4 family (q < 2^60), 2^27 - 2^11 + 1 at word 32 (m <= 10).
    @contextlib.contextmanager
    def switch(on=True):
        before = mm.USE_SOLINAS
        mm.USE_SOLINAS = on
        try:
            yield
        finally:
            mm.USE_SOLINAS = before

    @functools.lru_cache(maxsize=None)
    def params_of(q, m):
        return NttParams.make(q, m)

    def sol_params(bits, m):
        """The params of find_solinas_ntt_prime(bits, m) at m; the q takes the
        Solinas product at its word."""
        p = params_of(find_solinas_ntt_prime(bits, m), m)
        if mm.solinas_form(p.q) is None and mm.solinas_form32(p.q) is None:
            raise AssertionError(f"q {p.q:#x} is not of the Solinas form")
        return p

    switched = ("fwd_fused", "inv_fused", *twopass.KERNELS, "twist_mul", "r2_stage", "r4_stage")

    def solinas_slice():
        """Phases 18-27 (24-25 and 27, the demo, the fuzz draws and the product
        alone, off the switch); returns the Solinas rows of the kernel table."""
        phase(f"Solinas instantiations vs plain under the switch: K1 / K2 at every m they "
              f"serve (q62, and q27 to m10), K4-K7 at every m from 1 to {TWO_PASS_LAST_M} "
              f"(q61; q27 to m10), K8 and sixstep-rec at m16-m24, the K9 / K10 variants at "
              f"m14 batch {BATCH_HE} (q27 at m10), K3 and K11 unchanged")
        with switch():
            for word, bits, last in ((64, 62, fused.max_logn(64)), (32, 27, 10)):
                for m in range(1, last + 1):
                    p = sol_params(bits, m)
                    plan, ops = get_plan(p), pick_ops(p.q)
                    tabs = plan.device_tables(dev)
                    a = rand(p, BATCH_EVERY_M, hi=4 * p.q)
                    tag = f"q{bits} m{m} b{BATCH_EVERY_M}"
                    for strict in (True, False):
                        note(f"fwd_fused_solinas_u{word}", fused.fwd_fused(a, plan, strict),
                             sixstep.fwd_sixstep(a, ops, tabs.w, tabs.w_con, p.q, strict=strict),
                             f"{tag} K1 {'strict' if strict else 'lazy'}", quiet=True)
                    f = sixstep.fwd_sixstep(a, ops, tabs.w, tabs.w_con, p.q)
                    note(f"inv_fused_solinas_u{word}", fused.inv_fused(f, plan),
                         sixstep.inv_sixstep(f, ops, tabs.w_inv, tabs.w_inv_con,
                                             *plan.inv_consts, p.q), f"{tag} K2", quiet=True)
                print(f"  q {sol_params(bits, last).q:#x}: Solinas K1 (strict, lazy, inputs < "
                      f"4q) and K2 equal to plain at m1-m{last} batch {BATCH_EVERY_M}", flush=True)
            q61 = find_solinas_ntt_prime(61, REC_LAST_M)
            for word, q, last in ((64, q61, TWO_PASS_LAST_M), (32, sol_params(27, 10).q, 10)):
                for m in range(1, last + 1):
                    p = params_of(q, m)
                    plan, ops = get_plan(p), pick_ops(p.q)
                    tabs = plan.device_tables(dev)
                    n1 = sixstep.word_split(p.n, word)
                    tag = f"q {q:#x} m{m} (n1_log {n1})"
                    a = rand_dev(p, every_m_batch(m), lazy=True)
                    c = sixstep.fwd_cols(a, ops, tabs.w, tabs.w_con, p.q, n1)
                    note(f"fwd_cols_solinas_u{word}", twopass.fwd_cols(a, plan, n1), c,
                         f"{tag} K4 on input < 4q", quiet=True)
                    fr = {}
                    for strict in (True, False):
                        for keep_t in (False, True):
                            fr[strict, keep_t] = sixstep.fwd_rows(c, ops, tabs.w, tabs.w_con, p.q,
                                                                  n1, strict, keep_t)
                            note(f"fwd_rows_solinas_u{word}",
                                 twopass.fwd_rows(c, plan, n1, strict, keep_t), fr[strict, keep_t],
                                 f"{tag} K5 {strict} {keep_t}", quiet=True)
                    r = sixstep.inv_rows(fr[True, False], ops, tabs.w_inv, tabs.w_inv_con, p.q, n1)
                    note(f"inv_rows_solinas_u{word}", twopass.inv_rows(fr[True, False], plan, n1),
                         r, f"{tag} K6", quiet=True)
                    note(f"inv_rows_solinas_u{word}",
                         twopass.inv_rows(fr[True, True], plan, n1, input_transposed=True), r,
                         f"{tag} K6 from the transposed layout", quiet=True)
                    note(f"inv_cols_solinas_u{word}", twopass.inv_cols(r, plan, n1),
                         sixstep.inv_cols(r, ops, tabs.w_inv, tabs.w_inv_con, *plan.inv_consts,
                                          p.q, n1), f"{tag} K7", quiet=True)
                    del a, c, fr, r
                torch.cuda.empty_cache()
                print(f"  q {q:#x}: Solinas K4 (input < 4q), K5 (strict, lazy, both layouts), "
                      f"K6 (both layouts) and K7 equal to plain at m1-m{last} (batch "
                      f"{BATCH_EVERY_M}, 1 from m{LARGE_M})", flush=True)
            q27 = find_solinas_ntt_prime(27, 10)
            for word, q, m in [(64, q61, m) for m in range(16, REC_LAST_M + 1)] + [
                    (32, q27, m) for m in range(2, 11)]:
                p = params_of(q, m)
                plan, ops, l1 = get_plan(p), pick_ops(p.q), sixstep.rec_split(m)
                x = rand_dev(p, every_m_batch(m), lazy=True)
                for inverse in (False, True):
                    note(f"twist_mul_solinas_u{word}", rec.twist_mul(x, plan, l1, inverse),
                         sixstep.twist_mul(x, ops, plan.device_tables(dev).twist(l1, inverse),
                                           p.q), f"w{word} m{m} K8 inverse={inverse}", quiet=True)
                if m in (10, 16, 20, 24):
                    x = rand_dev(p, every_m_batch(m))
                    for strict in (True, False):
                        note("sixstep-rec", api.fwd_ntt(x, p, "sixstep-rec", lazy=not strict),
                             rec.plain_fwd(x, plan, strict), f"m{m} sixstep-rec {strict}",
                             quiet=True)
                    f = api.fwd_ntt(x, p, "sixstep-rec")
                    note("sixstep-rec", api.inv_ntt(f, p, "sixstep-rec"), rec.plain_inv(f, plan),
                         f"m{m} sixstep-rec inverse", quiet=True)
                del x
            torch.cuda.empty_cache()
            print(f"  Solinas K8 (both twists, input < 4q) equal to plain at q {q61:#x} "
                  f"m16-m{REC_LAST_M} and q {q27:#x} m2-m10; sixstep-rec (strict, lazy, "
                  "inverse) at q27 m10 and q61 m16, m20, m24", flush=True)
            for name, bits, m in SOLINAS_FAMILY:
                check_family(name, sol_params(bits, m), BATCH_HE)
                print(f"  {name} q{bits} m{m} b{BATCH_HE}: strict, lazy and inverse equal to "
                      "plain, strict equal to sixstep's, round trip exact", flush=True)
            torch.cuda.empty_cache()
            # one stage of each K9 / K10 entry point at the timed shapes
            for name, bits, m, batch, lt in SOLINAS_STAGES:
                p = sol_params(bits, m)
                plan, word = get_plan(p), int(name[-2:])
                tabs = plan.device_tables(dev)
                if name.startswith("r2"):
                    st, tab, kern, plain = (radix2.R2Stage(lt=lt, base=1 << (m - 1 - lt)), "w",
                                            radix2.r2_stage, radix2.plain_stage)
                else:
                    st, tab, kern, plain = (radix4.R4Stage(lt=lt), "w_r4", radix4.r4_stage,
                                            radix4.plain_stage)
                # lazy inputs at each family's bound: 4q radix-2, 8q radix-4 (e <= 61)
                bound_q = 4 if name.startswith("r2") else 8
                host = rng.integers(0, bound_q * p.q, size=(batch, p.n), dtype=np.uint64)
                x = mm.from_host(host, p.q, dev, wide=word == 64)
                args = (tabs.table(tab, word), tabs.table(radix2.con_name(tab, word), word), st,
                        p.q, word, radix2.consts_at(plan, word))
                note(name, kern(x, *args), plain(x, *args),
                     f"{name} one stage (lt {lt}) at m{m} batch {batch}, inputs < {bound_q}q")
            # K3 and K11 compute strict outputs: unchanged by the switch
            p = sol_params(62, 14)
            x, y = rand(p, BATCH_CHECK), rand(p, BATCH_CHECK)
            k3 = pointwise.mul_mod(x, y, p.q)
            note("mul_mod_u64", k3, pick_ops(p.q).mul_mod(x, y, p.q), "q62 K3 under the switch")
            with switch(False):
                if not torch.equal(k3, pick_ops(p.q).mul_mod(x, y, p.q)):
                    raise AssertionError("K3 under the switch differs from the Shoup plain path")
            p = sol_params(27, 10)
            x = rand(p, BATCH_CHECK)
            v = api.get_variant("mxu")
            k11 = api.fwd_ntt(x, p, "mxu")
            note("mxu", k11, v.fwd(get_plan(p), x, False, plain=True), "q27 m10 mxu under the switch")
            note("mxu", api.inv_ntt(k11, p, "mxu"), v.inv(get_plan(p), k11, plain=True),
                 "q27 m10 mxu inverse under the switch")
            with switch(False):
                if not torch.equal(k11, api.fwd_ntt(x, p, "auto")):
                    raise AssertionError("mxu under the switch differs from 'auto' off it")

        phase("main path under the switch: negacyclic_mul q62 m14 batch "
              f"{BATCH_HE}, q61 m16 batch 128, round trips m20 batch 16 and m24 batch 1 (flat "
              f"and sixstep-rec), DeviceNtt.negacyclic m14 batch {BATCH_HE}, q27 m10 batch "
              f"{BATCH_HE} (auto, sixstep, sixstep-rec) and the K9 / K10 variants' products")
        with switch():
            he = {k: (p, rand(p, b), rand(p, b)) for k, (p, b) in (
                ("q62 m14", (sol_params(62, 14), BATCH_HE)), ("q61 m16", (sol_params(61, 16), 128)),
                ("q27 m10", (sol_params(27, 10), BATCH_HE)), ("q60 m14", (sol_params(60, 14), BATCH_HE)))}
            rts = {k: (p, rand_dev(p, b)) for k, (p, b) in (
                ("q61 m20", (sol_params(61, 20), 16)), ("q61 m24", (sol_params(61, 24), 1)),
                ("q27 m10", (sol_params(27, 10), 16)))}
            ctx = api.DeviceNtt(he["q62 m14"][0], device=dev)
            products = (("q62 m14", "auto"), ("q61 m16", "auto"), ("q27 m10", "auto"),
                        ("q27 m10", "sixstep"), ("q62 m14", "radix2"), ("q60 m14", "radix4"),
                        ("q27 m10", "radix2-u32"), ("q27 m10", "radix4-u32"))
            torch.cuda.synchronize()
            launches_of.clear()
            prod = {(k, v): api.negacyclic_mul(he[k][1], he[k][2], he[k][0], variant=v)
                    for k, v in products}
            hprod = ctx.negacyclic(he["q62 m14"][1], he["q62 m14"][2])
            back = {(k, v): api.inv_ntt(api.fwd_ntt(x, p, v), p, v)
                    for k, (p, x) in rts.items() for v in ("auto", "sixstep-rec")}
            torch.cuda.synchronize()
        launches = launch_counts(launches_of, [f"{k}_solinas" for k in switched])
        shoup = {k: v for k, v in {**launch_counts(launches_of, switched),
                                   **launch_counts(launches_of, ("r4_stage",), ("w56",))}.items()
                 if v}
        print(f"  Solinas launch counts of this path: {launches}; Shoup launches of the same "
              f"kernels: {shoup or 'none'}; K3 {launch_counts(launches_of, ('mul_mod',))}",
              flush=True)
        idle = [k for k, v in launches.items() if v == 0]
        if idle or shoup or launches_of["mul_mod_u64"] == 0:
            raise AssertionError(f"Solinas kernels never launched by the path: {idle}; Shoup "
                                 f"launches on it: {shoup}")
        for (k, v), got in prod.items():
            p, x, y = he[k]
            if not torch.equal(got, api.negacyclic_mul(x, y, p, variant=v)):
                raise AssertionError(f"{k} {v}: the product differs with the switch off")
            ks = check_product_rows(p, x, y, got, f"{k} {v}")
            print(f"  {k} {v} (q {p.q:#x}): negacyclic_mul {tuple(x.shape)} under the switch "
                  f"equals the same call off it and, at coefficients {ks} of two rows, the "
                  "schoolbook product", flush=True)
        if not torch.equal(hprod, prod["q62 m14", "auto"]):
            raise AssertionError("DeviceNtt.negacyclic under the switch differs from "
                                 "negacyclic_mul")
        for (k, v), got in back.items():
            if not torch.equal(got, rts[k][1]):
                raise AssertionError(f"{k} {v}: the round trip under the switch is not exact")
        print(f"  DeviceNtt q62 m14 negacyclic equals negacyclic_mul; round trips "
              f"{', '.join(f'{k} {v}' for k, v in back)} exact", flush=True)
        del he, rts, prod, hprod, back, ctx
        torch.cuda.empty_cache()

        phase("the switch from the environment: NTT_MULMOD=solinas python -m ntt_tpu_torch "
              "correctness --full --device cuda, in a subprocess")
        out = subprocess.run([sys.executable, "-m", "ntt_tpu_torch", "correctness", "--full",
                              "--device", "cuda", "--seed", str(seed)],
                             env=dict(os.environ, NTT_MULMOD="solinas"), cwd=ROOT,
                             capture_output=True, text=True, timeout=900)
        lines = out.stdout.splitlines()
        if out.returncode != 0 or not lines or lines[-1] != "FAILURES: 0":
            print(out.stdout[-6000:], out.stderr[-6000:], flush=True)
            raise AssertionError(f"NTT_MULMOD=solinas correctness --full --device cuda: exit "
                                 f"{out.returncode}")
        rows = [re.match(r"q=0x[0-9a-f]+ m=\s*\d+ (\S+)\s+(\S+)", ln) for ln in lines[:-1]]
        tally = collections.Counter(r.group(2) if r else "UNPARSED" for r in rows)
        if set(tally) - {"OK", "SKIP"}:
            raise AssertionError(f"NTT_MULMOD=solinas correctness --full: {dict(tally)}")
        print(f"  exit 0, {dict(tally)}, {lines[-1]}", flush=True)

        phase(f"Solinas against Shoup times at the same q and shape (kernels from a CUDA graph "
              f"of launches, in turns Shoup, Solinas, Solinas, Shoup; plain versions under the "
              f"switch between CUDA events; {smi})")
        rows = []

        def timed(name, fn, x, plain, p, m, n1_log, batch, word, shape, plain_shape=None,
                  record=True):
            def graph_ms(on):
                with switch(on):
                    return lab.cuda_us(fn, x, 3, lab.INNER) / 1e3
            t = [graph_ms(on) for on in (False, True, True, False)]
            sol_ms, shoup_ms = min(t[1:3]), min(t[0], t[3])
            with switch():
                p_ms = cuda_ms(torch, plain, 2)
            base = name.rsplit("_", 1)[0].removesuffix("_solinas")
            b_ms, b_by = bound(*kernel_work(base, m, n1_log, batch, word, solinas=True))
            s_ms, _ = bound(*kernel_work(base, m, n1_log, batch, word))
            print(f"  {name} {shape} (q {p.q:#x}): Solinas {sol_ms * 1e3:.1f} us (bound "
                  f"{b_ms * 1e3:.1f}, {b_by}; {b_ms / sol_ms:.0%}), Shoup {shoup_ms * 1e3:.1f} us "
                  f"(bound {s_ms * 1e3:.1f}; {s_ms / shoup_ms:.0%}), plain {p_ms * 1e3:.1f} us"
                  + (f" ({plain_shape})" if plain_shape else ""), flush=True)
            row = {"name": name, "route": "cuda", "source": SOURCES[base],
                   "replaces": REPLACES[base], "launches": launches[name],
                   "max_abs_err": errs[name], "ms": sol_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": None, "shape": shape,
                   "shoup_ms": shoup_ms, "shoup_bound_ms": s_ms}
            if plain_shape:
                row["plain_shape"] = plain_shape
            if record:
                rows.append(row)

        for word, bits, m in ((64, 62, 14), (32, 27, 10)):
            p = sol_params(bits, m)
            plan, ops = get_plan(p), pick_ops(p.q)
            tabs = plan.device_tables(dev)
            batch = WORDS_PER_M >> m
            a = rand_dev(p, batch)
            with switch():
                f = fused.fwd_fused(a, plan)
            timed(f"fwd_fused_solinas_u{word}", lambda t: fused.fwd_fused(t, plan), a,
                  lambda: sixstep.fwd_sixstep(a, ops, tabs.w, tabs.w_con, p.q), p, m, m, batch,
                  word, f"m{m} batch {batch}")
            timed(f"inv_fused_solinas_u{word}", lambda t: fused.inv_fused(t, plan), f,
                  lambda: sixstep.inv_sixstep(f, ops, tabs.w_inv, tabs.w_inv_con,
                                              *plan.inv_consts, p.q), p, m, m, batch, word,
                  f"m{m} batch {batch}")
            del a, f
        for word, bits, m, batch in ((64, 61, 16, 128), (64, 61, 20, 16), (64, 61, 24, 1),
                                     (32, 27, 10, WORDS_PER_M >> 10)):
            p = sol_params(bits, m)
            plan, ops = get_plan(p), pick_ops(p.q)
            tabs = plan.device_tables(dev)
            n1 = sixstep.word_split(p.n, word)
            a = rand_dev(p, batch)
            with switch():
                c = twopass.fwd_cols(a, plan, n1)
                f = twopass.fwd_rows(c, plan, n1)
                r = twopass.inv_rows(f, plan, n1)
            args = (p, m, n1, batch, word, f"m{m} batch {batch}", None, m in (16, 10))
            timed(f"fwd_cols_solinas_u{word}", lambda t: twopass.fwd_cols(t, plan, n1), a,
                  lambda: sixstep.fwd_cols(a, ops, tabs.w, tabs.w_con, p.q, n1), *args)
            timed(f"fwd_rows_solinas_u{word}", lambda t: twopass.fwd_rows(t, plan, n1), c,
                  lambda: sixstep.fwd_rows(c, ops, tabs.w, tabs.w_con, p.q, n1), *args)
            timed(f"inv_rows_solinas_u{word}", lambda t: twopass.inv_rows(t, plan, n1), f,
                  lambda: sixstep.inv_rows(f, ops, tabs.w_inv, tabs.w_inv_con, p.q, n1), *args)
            timed(f"inv_cols_solinas_u{word}", lambda t: twopass.inv_cols(t, plan, n1), r,
                  lambda: sixstep.inv_cols(r, ops, tabs.w_inv, tabs.w_inv_con, *plan.inv_consts,
                                           p.q, n1), *args)
            if m in (24, 10):
                l1 = sixstep.rec_split(m)
                tw = plan.device_tables(dev).twist(l1, False)
                timed(f"twist_mul_solinas_u{word}", lambda t: rec.twist_mul(t, plan, l1), a,
                      lambda: sixstep.twist_mul(a, ops, tw, p.q), p, m, l1, batch, word,
                      f"m{m} batch {batch}")
            del a, c, f, r
            torch.cuda.empty_cache()
        for name, bits, m, batch, lt in SOLINAS_STAGES:
            p = sol_params(bits, m)
            plan, word = get_plan(p), int(name[-2:])
            tabs = plan.device_tables(dev)
            if name.startswith("r2"):
                st, tab, kern, plain = (radix2.R2Stage(lt=lt, base=1 << (m - 1 - lt)), "w",
                                        radix2.r2_stage, radix2.plain_stage)
            else:
                st, tab, kern, plain = (radix4.R4Stage(lt=lt), "w_r4", radix4.r4_stage,
                                        radix4.plain_stage)
            x = rand_dev(p, batch, lazy=True) if word == 64 else rand_dev(p, batch)
            args = (tabs.table(tab, word), tabs.table(radix2.con_name(tab, word), word), st, p.q,
                    word, radix2.consts_at(plan, word))
            small = x[:LAB_BATCH_CHECK].contiguous()
            timed(name, lambda t: kern(t, *args), x, lambda: plain(small, *args), p, m, lt, batch,
                  word, f"m{m} batch {batch}, one stage (lt {lt})",
                  plain_shape=f"m{m} batch {LAB_BATCH_CHECK}")
            del x, small
        print(f"  Solinas against Shoup (the kernel table's rows; K4-K7 at m16 and m10): "
              f"{json.dumps(rows)}", flush=True)

        # the lab under the switch: L1 / L2 / diag_math at the lab's q of each
        # word where it takes the Solinas product (the word-64 q at m14, the
        # word-32 q at m10); the lab's path; the HE demo; a fuzz draw of each
        # width; the Solinas lab kernels' times beside their Shoup twins
        lab_sol = {64: lab.case_params("u64", 14), 32: lab.case_params("u32", 10)}
        phase(f"Solinas lab kernels vs plain under the switch: L1 (both groups) and L2 "
              f"(strict, lazy, kept transposed) and diag_math at m14 batch {LAB_BATCH_CHECK} "
              f"(q {lab_sol[64].q:#x}) and m10 (q {lab_sol[32].q:#x}), L1 / L2 / diag_math at "
              f"every m each q serves, batch {LAB_EVERY_M_BATCH}; L1's and L2's launchers refusing an "
              "N beyond one block's shared memory under both policies")
        with switch():
            for word, p in lab_sol.items():
                plan = get_plan(p)
                sol = mm.solinas_args(p.q, word)
                if sol is None:
                    raise AssertionError(f"the lab's q {p.q:#x} takes no Solinas product")
                n1 = lab.lab_split(p.m)
                a = rand(p, LAB_BATCH_CHECK, hi=4 * p.q)
                tag = f"q {p.q:#x} m{p.m} b{LAB_BATCH_CHECK}"
                layouts = ((True, False), (False, False), (True, True))
                for group in (1, 2):
                    for strict, keep_t in layouts:
                        note(f"fwd_fused_v2_r{2 * group}_solinas_u{word}",
                             fused_lab.fwd_fused_v2(a, plan, n1, group, strict, keep_t),
                             fused_lab.plain(a, plan, n1, strict, keep_t),
                             f"{tag} L1 group {group} {strict} {keep_t}", quiet=True)
                for strict, keep_t in layouts:
                    note(f"fwd_fused_v3_solinas_u{word}",
                         fused_lab.fwd_fused_v3(a, plan, n1, strict, keep_t),
                         fused_lab.plain(a, plan, n1, strict, keep_t),
                         f"{tag} L2 {strict} {keep_t}", quiet=True)
                note(f"fwd_fused_v2_r4_solinas_u{word}", fused_lab.fwd_fused_v2(a, plan, 4),
                     fused_lab.plain(a, plan, 4), f"{tag} L1 group 2 at n1_log 4", quiet=True)
                note(f"fwd_fused_v3_solinas_u{word}", fused_lab.fwd_fused_v3(a, plan, 4),
                     fused_lab.plain(a, plan, 4), f"{tag} L2 at n1_log 4", quiet=True)
                if not torch.equal(fused_lab.fwd_fused_v3(a, plan, n1), fused.fwd_fused(a, plan)):
                    raise AssertionError(f"{tag}: Solinas L2 differs from Solinas K1")
                note(f"diag_math_solinas_u{word}", probes.diag_math(a, plan, p.m),
                     probes.plain_math(a, plan, p.m), f"{tag} diag_math", quiet=True)
                note(f"diag_math_solinas_u{word}", probes.diag_math(a, plan, 0), a,
                     f"{tag} diag_math at 0 rounds: its input", quiet=True)
                # one N beyond one block's shared memory: both policies'
                # launchers of L1 and L2 refuse it before launching
                big = fused.max_logn(word) + 1
                buf = torch.zeros(1 << big, dtype=plan.dtype, device=dev)
                tabs = plan.device_tables(dev)
                w_con = tabs.w_con.data_ptr()
                for name, con, group, extra in (
                        (f"fwd_fused_v3_u{word}", w_con, (), ()),
                        (f"fwd_fused_v3_solinas_u{word}", None, (), sol),
                        (f"fwd_fused_v2_u{word}", w_con, (2,), ()),
                        (f"fwd_fused_v2_solinas_u{word}", None, (2,), sol)):
                    try:
                        native.launch(name, buf.data_ptr(), buf.data_ptr(), tabs.w.data_ptr(),
                                      con, p.q, 1, big, big // 2, *group, 1, 0, *extra,
                                      native.stream(dev))
                    except RuntimeError as err:
                        if "failed to launch" not in str(err):
                            raise
                    else:
                        raise AssertionError(f"{name} launched at N = 2^{big}")
                print(f"  {tag}: Solinas {sol} L1 (groups 1 and 2), L2 (strict, lazy, kept "
                      f"transposed; n1_log {n1} and 4) and diag_math ({p.m} rounds; 0 rounds: "
                      f"its input) equal to plain, inputs < 4q; L2 equal to K1; L1 and L2 at N = 2^{big} refused "
                      "by both instantiations", flush=True)
                del a, buf
            # every m the lab's q serves (2N | q - 1 up to m = k - 1) within one block
            for word, p in lab_sol.items():
                last = min(fused.max_logn(word), mm.solinas_args(p.q, word)[1] - 1)
                lab_every_m(lambda m, q=p.q: NttParams.make(q, m), last,
                            f"w{word} q {p.q:#x} (Solinas)")

        phase("the lab path under the switch: python -m ntt_tpu_torch.lab --cases both "
              "--no-time at m14 and at m10, every launch count set to 0 before it")
        lab_launches = collections.Counter()
        lab_kernels = fused_lab.KERNELS + ("diag_math",)
        for word, p in lab_sol.items():
            torch.cuda.synchronize()
            launches_of.clear()
            with switch():
                records = lab.main(["--cases", "both", "--no-time", "--m", str(p.m)])
            torch.cuda.synchronize()
            got = {k: v for k, v in launches_of.items() if v}
            print(f"  m{p.m}: launch counts {got}", flush=True)
            if len(records) != 2 * len(lab.CANDIDATES) or not all(r["exact"] for r in records):
                raise AssertionError(f"the lab path at m{p.m} did not check every candidate")
            taken = {r["case"]: r["product"] for r in records}
            if not taken[f"u{word}"].startswith("Solinas"):
                raise AssertionError(f"m{p.m}: the u{word} case took {taken[f'u{word}']}")
            want = [f"{k}_solinas_u{word}" for k in lab_kernels + ("fwd_fused", "inv_fused")]
            idle = [k for k in want if not got.get(k)]
            shoup = [f"{k}_u{word}" for k in lab_kernels if got.get(f"{k}_u{word}")]
            if idle or shoup:
                raise AssertionError(f"m{p.m}: Solinas entry points never launched {idle}; "
                                     f"Shoup lab kernels launched at word {word}: {shoup}")
            lab_launches.update({k: got[k] for k in want[:len(lab_kernels)]})
            print(f"  m{p.m}: {len(records)} candidates bit-exact; products taken {taken}; "
                  f"every Solinas lab entry point at word {word} launched, no Shoup L1 / L2 / "
                  "diag_math there", flush=True)
        launches.update(lab_launches)

        phase("the HE demo on the card: python -m ntt_tpu_torch.examples.he_demo --check "
              "(m10, three 30-bit channels, batch 4), in-process")
        demo = he_demo.main(["--check"])
        if not demo["checked"] or demo["device_ms"] is None:
            raise AssertionError(f"the demo did not check on the card: {demo}")

        phase(f"fuzz draws through the API on the card (seed {seed}, FUZZ_SEED-style): one "
              "(q_bits, m) instance of each width against the plain versions and the NTT by "
              "its definition, and negacyclic_mul at m5 against the schoolbook product")
        frng = np.random.default_rng(seed)

        def fuzz_draw(bits, ms):
            """tests/test_torch_fuzz.py's draw: redrawn from the same
            generator until the pair has an NTT prime."""
            for _ in range(64):
                q_bits, m = int(frng.integers(*bits)), int(frng.integers(*ms))
                try:
                    return q_bits, NttParams.generate(q_bits, m)
                except ValueError:
                    continue
            raise AssertionError(f"no NTT prime in 64 draws (seed {seed})")

        for bits, ms in (((13, 30), (6, 10)), ((31, 61), (6, 10)), ((62, 63), (6, 9))):
            q_bits, p = fuzz_draw(bits, ms)
            plan = get_plan(p)
            host = frng.integers(0, p.q, size=(2, p.n), dtype=np.uint64)
            names = ["radix2", "sixstep"] + (["radix4", "r4r2"] if q_bits <= api.R4_MAX_Q_BITS
                                             else []) + (["radix4-w56"] if q_bits <= 52 else [])
            js = sorted({0, 1, p.n - 1, *frng.integers(0, p.n, 4).tolist()})
            want = [[direct_ntt_at(host[r], j, p) for j in js] for r in range(2)]
            tag = f"seed {seed} q_bits {q_bits} m{p.m} q {p.q:#x}"
            for name in names:
                v = api.get_variant(name)
                x = mm.from_host(host, p.q, dev, wide=v.word64)
                f = api.fwd_ntt(x, p, name)
                if name == "sixstep":  # the plain six-step (strict outputs: any split's)
                    tabs = plan.device_tables(dev)
                    plain_f = sixstep.fwd_sixstep(x, pick_ops(p.q), tabs.w, tabs.w_con, p.q)
                else:
                    plain_f = v.fwd(plan, x, False, plain=True)
                if not torch.equal(f, plain_f):
                    raise AssertionError(f"{tag} {name}: forward differs from plain")
                hf = mm.to_host(f)
                if [[int(hf[r, j]) for j in js] for r in range(2)] != want:
                    raise AssertionError(f"{tag} {name}: forward differs from the NTT by its "
                                         "definition")
                lazy = mm.to_host(api.fwd_ntt(x, p, name, lazy=True))
                if int(lazy.max()) >= lazy_bound(name, p.m) * p.q:
                    raise AssertionError(f"{tag} {name}: lazy output beyond its bound")
                if not torch.equal(api.inv_ntt(f, p, name), x):
                    raise AssertionError(f"{tag} {name}: round trip differs")
            print(f"  {tag}: {', '.join(names)} forward equal to plain and, at outputs {js} of "
                  "both rows, to the NTT by its definition; lazy within bound; round trips "
                  "exact", flush=True)
        q_bits, p = fuzz_draw((20, 62), (5, 6))
        x, y = rand(p, 2), rand(p, 2)
        prod = api.negacyclic_mul(x, y, p)
        hx, hy, hp = (mm.to_host(t) for t in (x, y, prod))
        for r in range(2):
            for k in range(p.n):
                if int(hp[r, k]) != schoolbook_at(hx[r], hy[r], k, p):
                    raise AssertionError(f"seed {seed} q {p.q:#x} m5: product coeff {k} differs")
        print(f"  seed {seed} q_bits {q_bits} m5 q {p.q:#x}: negacyclic_mul equal to the "
              "schoolbook product at every coefficient of both rows", flush=True)

        phase(f"Solinas lab kernels against their Shoup twins at the same q and shape (kernels "
              f"from a CUDA graph, in turns Shoup, Solinas, Solinas, Shoup; plain versions at "
              f"batch {LAB_BATCH_CHECK} under the switch; {smi})")
        lab_words = 512 << 14  # the lab's shape at m14, as many words at m10
        for word, p in lab_sol.items():
            plan = get_plan(p)
            n1, batch = lab.lab_split(p.m), lab_words >> p.m
            x = rand_dev(p, batch)
            small = x[:LAB_BATCH_CHECK].contiguous()
            cands = lab.candidates(plan, n1)
            for cand_name in ("v2-r2", "v2-r4", "v3", "diag-math"):
                cand = cands[cand_name]
                timed(f"{cand.kernel}_solinas_u{word}", cand.fn, x,
                      lambda: cand.plain(small), p, p.m, n1, batch, word,
                      f"m{p.m} batch {batch}", plain_shape=f"m{p.m} batch {LAB_BATCH_CHECK}")
            del x, small

        phase(f"the Solinas product alone (pointwise.solinas_mul, on no transform path) "
              f"against the plain modmath.mul_mod_q2_solinas / mul_mod32_q2_solinas on the "
              f"same CUDA tensors: tests/test_torch_solinas.py's operand sets (the lazy range "
              f"with its edges, the whole word with 0 and 2^word - 1) and "
              f"{SOLINAS_RANDOM_PAIRS} pairs a q over the whole word (seed {seed})")
        prng = np.random.default_rng(seed)
        for q, t_mult, word in SOLINAS_PRODUCTS:
            form = mm.solinas_form(q) if word == 64 else mm.solinas_form32(q)
            fold = mm.mul_mod_q2_solinas if word == 64 else mm.mul_mod32_q2_solinas
            udt, idt = (np.uint64, np.int64) if word == 64 else (np.uint32, np.int32)
            sets = {"whole word": full_range_operands(np, q, word),
                    "random": prng.integers(0, (1 << word) - 1, size=(2, SOLINAS_RANDOM_PAIRS),
                                            dtype=np.uint64, endpoint=True)}
            if t_mult:
                sets[f"w < q, t < {t_mult}q"] = lazy_operands(np, q, t_mult * q)
            for what, (w, t) in sets.items():
                wd, td = (torch.from_numpy(v.astype(udt).view(idt)).to(dev) for v in (w, t))
                note(f"solinas_mul_u{word}", pointwise.solinas_mul(wd, td, q),
                     fold(wd, td, q, *form),
                     f"q {q:#x} (e, k) {form} {what}, {len(w)} pairs", quiet=True)
            print(f"  q {q:#x} (e, k) {form}, word {word}: {', '.join(sets)} equal to plain",
                  flush=True)
        torch.cuda.synchronize()
        print(f"  launches of the check: {launch_counts(launches_of, ('solinas_mul',))}",
              flush=True)
        return rows

    phase(f"reference-family variants vs plain: every m from each one's least to "
          f"{FAMILY_LAST_M} (batch {BATCH_EVERY_M}), and "
          + ", ".join(f"m{m} batch {b}" for m, b in FAMILY_LARGE) + " at word 64")
    before_modes = launches_of.copy()
    for name, bits in FAMILY:
        v = api.get_variant(name)
        for m in range(v.min_m, FAMILY_LAST_M + 1):
            check_family(name, family_params(bits, m), BATCH_EVERY_M)
        large = [(m, b) for m, b in FAMILY_LARGE if bits >= 52]
        for m, b in large:
            t0 = time.perf_counter()
            p = family_params(bits, m)
            check_family(name, p, b)
            print(f"    {name} q{bits} m{m} b{b}: {time.perf_counter() - t0:.1f} s "
                  "(tables built in it)", flush=True)
        torch.cuda.synchronize()
        print(f"  {name} q{bits}: strict, lazy (below {lazy_bound(name, 2)}q / "
              f"{lazy_bound(name, 1)}q at even / odd m) and inverse equal to plain, strict equal "
              f"to sixstep's, round trip exact at m{v.min_m}-m{FAMILY_LAST_M} batch "
              f"{BATCH_EVERY_M}" + "".join(f", m{m} batch {b}" for m, b in large), flush=True)
        torch.cuda.empty_cache()
    modes = sorted(tuple(k.split("/")[1:]) for k in launches_of - before_modes
                   if k.startswith("mode/"))
    print(f"  K9 / K10 (entry point, mode, twiddle view) run: {modes}", flush=True)
    want_modes = {("r2_stage_u64", k, "std") for k in ("fwd", "bkw", "final", "seal_final")}
    want_modes |= {("r2_stage_u64", "fwd", v) for v in ("hexl", "r2_16", "r4r2")}
    want_modes |= {("r2_stage_u32", k, "std") for k in ("fwd", "bkw", "final")}
    want_modes |= {(k, mode, "pairs") for k in ("r4_stage_u32", "r4_stage_u64", "r4_stage_w56")
                   for mode in ("r2_fwd", "r2_bkw")}
    want_modes |= {(k, mode, "expand") for k in ("r4_stage_u32", "r4_stage_u64", "r4_stage_w56")
                   for mode in ("r4_fwd", "r4_inv")}
    want_modes |= {("r4_stage_u64", mode, "region") for mode in ("r4_fwd", "r4_inv")}
    if want_modes - set(modes):
        raise AssertionError(f"K9 / K10 modes never run: {sorted(want_modes - set(modes))}")

    # each entry point on one stage of the timed shape (m14 batch 1024), as
    # the kernel table's rows: kernel against plain_stage
    stage_cases = {}
    for name, bits, mode, lt in (("r2_stage_u64", 62, radix2.FWD, 6),
                                 ("r2_stage_u32", 29, radix2.FWD, 6),
                                 ("r4_stage_u64", 60, radix4.R4_FWD, 6),
                                 ("r4_stage_u32", 27, radix4.R4_FWD, 6),
                                 ("r4_stage_w56", 52, radix4.R4_FWD, 6)):
        p = family_params(bits, 14)
        plan = get_plan(p)
        word = 56 if name.endswith("w56") else int(name[-2:])
        tabs = plan.device_tables(dev)
        if name.startswith("r2"):
            st, tab = radix2.R2Stage(lt=lt, mode=mode, base=1 << (13 - lt)), "w"
            kern, plain = radix2.r2_stage, radix2.plain_stage
        else:
            st, tab = radix4.R4Stage(lt=lt, mode=mode), "w_r4"
            kern, plain = radix4.r4_stage, radix4.plain_stage
        con = radix2.con_name(tab, word)
        host = rng.integers(0, 4 * p.q, size=(BATCH_HE, p.n), dtype=np.uint64)
        x = mm.from_host(host, p.q, dev, wide=word != 32)
        args = (tabs.table(tab, word), tabs.table(con, word), st, p.q, word,
                radix2.consts_at(plan, word))
        note(name, kern(x, *args), plain(x, *args), f"{name} one stage (lt {lt}) at m14 "
             f"batch {BATCH_HE}, inputs < 4q")
        stage_cases[name] = (kern, plain, x, args, lt, word)

    phase(f"main path of the variant slice: negacyclic_mul of every variant at m14 batch "
          f"{BATCH_HE}, each at its widest q, against 'auto'")
    he5 = {}
    for name, bits in FAMILY_HE:
        p = family_params(bits, 14)
        if bits not in he5:
            he5[bits] = (p, rand(p, BATCH_HE), rand(p, BATCH_HE))
    want5 = {bits: api.negacyclic_mul(x, y, p) for bits, (p, x, y) in he5.items()}
    torch.cuda.synchronize()
    launches_of.clear()
    prod5 = {(name, bits): api.negacyclic_mul(he5[bits][1], he5[bits][2], he5[bits][0],
                                              variant=name)
             for name, bits in FAMILY_HE}
    torch.cuda.synchronize()
    launches5 = {**launch_counts(launches_of, ("r2_stage", "r4_stage")),
                 **launch_counts(launches_of, ("r4_stage",), ("w56",)),
                 **launch_counts(launches_of, ("fwd_fused", "inv_fused", "mul_mod"))}
    print(f"  launch counts of this path: {launches5}", flush=True)
    idle = [k for k in STAGE_KERNELS + ("fwd_fused_u64", "inv_fused_u64") if launches5[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched by the variant slice's path: {idle}")
    for (name, bits), got in prod5.items():
        p = he5[bits][0]
        if not torch.equal(got, want5[bits]):
            raise AssertionError(f"{name} q{p.q.bit_length()}: negacyclic_mul differs from "
                                 "'auto''s")
    print("  " + ", ".join(f"{n} (q {he5[b][0].q:#x})" for n, b in FAMILY_HE)
          + f": negacyclic_mul {tuple(he5[62][1].shape)} equals 'auto''s", flush=True)
    del want5


    def mxu_params(m):
        """The mxu slice's q at m: 0xfff0001 where 2N divides q - 1, the
        largest 28-bit NTT prime of N beyond."""
        return NttParams.make(MXU_QS[0], m) if m <= 15 else NttParams.generate(28, m)

    mxu_sizes = [(m, 1 << (MXU_WORDS_LOG - m)) for m in range(1, MXU_LAST_M + 1)] + [(24, 1)]
    phase(f"K11 limb_matmul vs plain: both contracts, with and without the scale, at every m "
          f"from 1 to {MXU_LAST_M} (batch 2^({MXU_WORDS_LOG} - m)) and m24 batch 1, q "
          + " and ".join(f"{q:#x}" for q in MXU_QS))
    for q in MXU_QS:
        for m, batch in mxu_sizes:
            n1, n2 = 1 << m // 2, 1 << (m - m // 2)
            x = torch.randint(0, q, (batch, n1, n2), generator=gen, device=dev, dtype=torch.int32)
            s_tab = torch.randint(0, q, (n1, n2), generator=gen, device=dev, dtype=torch.int32)
            s_con = ((s_tab.to(torch.int64) << 32) // q).to(torch.int32)
            for contract, k in (("left", n1), ("right", n2)):
                # limbs over their whole range 0..127: the diagonals' largest sums
                mat = torch.randint(0, 128, (4, k, k), generator=gen, device=dev,
                                    dtype=torch.int8)
                for scale in (None, (s_tab, s_con)):
                    note(f"limb_matmul_{contract}", mxu.limb_matmul(mat, x, q, contract, scale),
                         mxu.limb_matmul_plain(mat, x, q, contract, scale),
                         f"q {q:#x} m{m} b{batch} K11 {contract}"
                         f"{' scaled' if scale else ''}", quiet=True)
            del x, s_tab, s_con
        torch.cuda.synchronize()
        print(f"  q {q:#x}: K11 left and right, with and without the scale, equal to plain "
              f"at m1-m{MXU_LAST_M} (2^{MXU_WORDS_LOG} words) and m24 b1", flush=True)
    # the worst case at the deepest K: every limb 127 on both sides, the
    # largest diagonal sums K11 can meet (K11 and plain read bits 0-27)
    q_w, n_w = MXU_QS[0], 1 << 12  # m24: N1 = N2 = 4096
    x = torch.full((1, n_w, n_w), 0x0FFFFFFF, device=dev, dtype=torch.int32)
    s_tab = torch.randint(0, q_w, (n_w, n_w), generator=gen, device=dev, dtype=torch.int32)
    s_con = ((s_tab.to(torch.int64) << 32) // q_w).to(torch.int32)
    mat = torch.full((4, n_w, n_w), 127, device=dev, dtype=torch.int8)
    for contract in ("left", "right"):
        for scale in (None, (s_tab, s_con)):
            note(f"limb_matmul_{contract}", mxu.limb_matmul(mat, x, q_w, contract, scale),
                 mxu.limb_matmul_plain(mat, x, q_w, contract, scale),
                 f"q {q_w:#x} m24 b1 K11 {contract}{' scaled' if scale else ''}, every limb 127",
                 quiet=True)
    torch.cuda.synchronize()
    del x, s_tab, s_con, mat
    print(f"  q {q_w:#x} m24 (K = 4096 in both contracts), every limb 127: K11 left and right, "
          f"with and without the scale, equal to plain", flush=True)
    print("  K11's body at each m (left over N1, right over N2): " + ", ".join(
        f"m{m} {mxu.body(1 << m // 2)} / {mxu.body(1 << (m - m // 2))}"
        for m, _ in mxu_sizes), flush=True)
    torch.cuda.empty_cache()

    phase(f"main path of the mxu slice: fwd_ntt / inv_ntt through 'mxu' at every m from 1 to "
          f"{MXU_LAST_M} and m24 (batch {BATCH_EVERY_M}, 1 from m{LARGE_M}), and negacyclic_mul "
          f"at m14 batch {BATCH_HE}, against 'auto'")
    mx_params = {m: mxu_params(m) for m, _ in mxu_sizes}
    mx_in = {m: rand_dev(p, every_m_batch(m)) for m, p in mx_params.items()}
    mp14 = mx_params[14]
    he6 = (rand_dev(mp14, BATCH_HE), rand_dev(mp14, BATCH_HE))
    for m, p in mx_params.items():  # the host tables: set-up, outside the counted path
        get_plan(p).device_tables(dev).mxu(False)
        get_plan(p).device_tables(dev).mxu(True)
    torch.cuda.synchronize()
    launches_of.clear()
    fwd6 = {m: api.fwd_ntt(x, mx_params[m], "mxu") for m, x in mx_in.items()}
    lazy6 = {m: api.fwd_ntt(x, mx_params[m], "mxu", lazy=True) for m, x in mx_in.items()}
    back6 = {m: api.inv_ntt(f, mx_params[m], "mxu") for m, f in fwd6.items()}
    prod6 = api.negacyclic_mul(*he6, mp14, variant="mxu")
    torch.cuda.synchronize()
    launches6 = {**limb_launches(launches_of), **launch_counts(launches_of, ("mul_mod",))}
    print(f"  launch counts of this path: {launches6}", flush=True)
    idle = [k for k in LIMB_KERNELS + ("mul_mod_u32",) if launches6[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched by the mxu slice's path: {idle}")
    for m, x in mx_in.items():
        p = mx_params[m]
        if not torch.equal(fwd6[m], api.fwd_ntt(x, p)) or not torch.equal(lazy6[m], fwd6[m]):
            raise AssertionError(f"mxu m{m}: the forward (strict or lazy) differs from 'auto''s")
        if not torch.equal(back6[m], x):
            raise AssertionError(f"mxu m{m}: inv_ntt(fwd_ntt(a)) != a")
    if not torch.equal(prod6, api.negacyclic_mul(*he6, mp14)):
        raise AssertionError("mxu m14: negacyclic_mul differs from 'auto''s")
    ks = check_product_rows(mp14, *he6, prod6, "mxu m14")
    print(f"  mxu at m1-m{MXU_LAST_M} and m24 (q {mx_params[1].q:#x} to m15, the largest 28-bit "
          f"NTT prime beyond): forward (strict, lazy) equal to 'auto''s, round trip exact; "
          f"negacyclic_mul {tuple(prod6.shape)} q {mp14.q:#x} equal to 'auto''s and, at "
          f"coefficients {ks} of two rows, the schoolbook product", flush=True)
    del fwd6, lazy6, back6, prod6, mx_in
    torch.cuda.empty_cache()

    phase("the CLI on the card: python -m ntt_tpu_torch list, and correctness --full "
          "--device cuda in-process, every launch count set to 0 before it")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["list"])
    listed = [line.split()[0] for line in buf.getvalue().splitlines()[1:]]
    if rc != 0 or listed != sorted(api.variants()):
        raise AssertionError(f"list printed {listed}, the registry has {sorted(api.variants())}")
    print(f"  list: {len(listed)} variants, the registry's", flush=True)
    torch.cuda.synchronize()
    launches_of.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["correctness", "--full", "--device", "cuda", "--seed", str(seed)])
    torch.cuda.synchronize()
    lines = buf.getvalue().splitlines()
    rows = [re.match(r"q=0x[0-9a-f]+ m=\s*\d+ (\S+)\s+(\S+)", ln) for ln in lines[:-1]]
    tally = collections.Counter(r.group(2) if r else "UNPARSED" for r in rows)
    if rc != 0 or lines[-1] != "FAILURES: 0" or set(tally) - {"OK", "SKIP"}:
        print("\n".join(ln for ln in lines if " OK " not in ln), flush=True)
        raise AssertionError(f"correctness --full --device cuda: exit {rc}, {dict(tally)}")
    launches7 = shoup_launches()
    print(f"  correctness --full --device cuda: {dict(tally)} over the 19 fixtures "
          f"({', '.join(sorted({r.group(1) for r in rows if r.group(2) == 'SKIP'}))} refused "
          f"beyond one block), {lines[-1]}; launch counts {launches7}", flush=True)
    idle = [k for k, v in launches7.items() if v == 0 and not k.startswith("mul_mod")]
    if idle:
        raise AssertionError(f"kernels never launched by the CLI's sweep: {idle}")


    # -- the dist slice: the distributed six-step on shard-shaped K4-K8 --------
    # Phases 28-30: the shard launches against their plain versions on the
    # same CUDA tensors, the dist entry points at full width on a local mesh
    # of DIST_SHARDS shards on this card (and one forward through a 1-rank
    # NCCL world, the all_to_all_single path on CUDA tensors), and the
    # compositions' device times beside the flat 'sixstep'.
    import torch.distributed as tdist

    from ntt_tpu_torch.dist import sixstep as dist

    # (params, batch) of the dist path: BASELINE.json configs[4]'s N = 2^20
    # at both widths (dist_params' 30-bit q, the 62-bit bench q) and its
    # N = 2^24 at word 64
    dist_cases = {"m20-q30": (dist_params(20), 16), "m20-q62": (bench_params(20, 62), 16),
                  "m24-q62": (bench_params(24, 62), 1)}

    def rand_words(p, batch, words, below=1):
        """(batch, words) values below ``below`` q (wrapping as the unsigned
        words do), drawn on the card."""
        dtype = mm.dtype_for(p.q)
        x = torch.randint(0, p.q, (batch, words), generator=gen, device=dev, dtype=dtype)
        if below > 1:
            x += torch.randint(0, below, (batch, words), generator=gen, device=dev,
                               dtype=dtype) * mm.s64(p.q)
        return x

    def shard_logs(plan, nd):
        """(n1_log, n2_log, log2 D) of the dist path's default split at D."""
        n1 = dist._split_for(plan, nd)
        return n1, plan.m - n1, nd.bit_length() - 1

    def check_row_shard(p, plan, ops, tabs, batch, n1, n2, row0, r, tag, word, quiet=True):
        """K5 (strict, lazy, both layouts) and K6 (from both layouts) on rows
        [row0, row0 + 2^r) against their plain versions."""
        x = rand_words(p, batch, 1 << (r + n2), 4)  # K4's output: below 4q
        for strict in (True, False):
            for keep_t in (False, True):
                note(f"fwd_rows_shard_{word}",
                     twopass.fwd_rows(x, plan, n1, strict, keep_t, row0, r),
                     sixstep.fwd_rows(x, ops, tabs.w, tabs.w_con, p.q, n1, strict, keep_t, row0,
                                      r),
                     f"{tag} K5 {'strict' if strict else 'lazy'}"
                     f"{', kept transposed' if keep_t else ''}", quiet)
        y = rand_words(p, batch, 1 << (r + n2))
        for t_in in (False, True):
            note(f"inv_rows_shard_{word}", twopass.inv_rows(y, plan, n1, t_in, row0, r),
                 sixstep.inv_rows(y, ops, tabs.w_inv, tabs.w_inv_con, p.q, n1, t_in, row0, r),
                 f"{tag} K6{' from the transposed layout' if t_in else ''}", quiet)

    def dist_slice():
        """Phases 28-30; returns the shard rows of the kernel table."""
        phase(f"shard kernels vs plain: K5 (strict, lazy, both layouts) and K6 (both layouts) "
              f"at every row0 of D = {' and '.join(map(str, DIST_CHECK_SHARDS))} and on the "
              f"four chunks of the last shard, K4 / K7 on N2/D lanes, K8 on every row shard: "
              + ", ".join(f"{s} batch {b}" for s, b in TWO_PASS)
              + "; K5 / K6 under the switch at q61 m20")
        done = []
        for size, batch in TWO_PASS:
            p = tp_params[size]
            plan, ops = get_plan(p), pick_ops(p.q)
            tabs = plan.device_tables(dev)
            word = f"u{plan.word}"
            for nd in DIST_CHECK_SHARDS:
                n1, n2, dl = shard_logs(plan, nd)
                rl, ll = n1 - dl, n2 - dl
                tag = f"{size} b{batch} D{nd} (n1_log {n1})"
                x = rand_words(p, batch, 1 << (n1 + ll), 4)
                note(f"fwd_cols_shard_{word}", twopass.fwd_cols(x, plan, n1, n2_log=ll),
                     sixstep.fwd_cols(x, ops, tabs.w, tabs.w_con, p.q, n1),
                     f"{tag} K4 on 2^{ll} lanes, input < 4q", quiet=True)
                x = rand_words(p, batch, 1 << (n1 + ll))
                note(f"inv_cols_shard_{word}", twopass.inv_cols(x, plan, n1, n2_log=ll),
                     sixstep.inv_cols(x, ops, tabs.w_inv, tabs.w_inv_con, *plan.inv_consts, p.q,
                                      n1), f"{tag} K7 on 2^{ll} lanes", quiet=True)
                shards = [(j << rl, rl) for j in range(nd)]
                if rl >= 2:  # the chunks of n_chunks 4 in the last shard
                    shards += [(((nd - 1) << rl) + (c << (rl - 2)), rl - 2) for c in range(4)]
                for row0, r in shards:
                    check_row_shard(p, plan, ops, tabs, batch, n1, n2, row0, r,
                                    f"{tag} rows [{row0}, +2^{r})", word)
                l1 = dist._rec_l1_for(plan, nd)
                r8 = l1 - dl
                for j in range(nd):
                    x = rand_words(p, batch, 1 << (r8 + p.m - l1), 4)
                    for inverse in (False, True):
                        tw = tuple(t[j << r8:(j + 1) << r8] for t in tabs.twist(l1, inverse))
                        note(f"twist_mul_shard_{word}",
                             rec.twist_mul(x, plan, l1, inverse, j << r8, r8),
                             sixstep.twist_mul(x, ops, tw, p.q),
                             f"{tag} K8 rows [{j << r8}, +2^{r8}) of N1 = 2^{l1}", quiet=True)
                done.append(f"{size} D{nd}")
                del x
            torch.cuda.empty_cache()
        print(f"  K4 / K7 (N2/D lanes), K5 (strict, lazy, both layouts) and K6 (both layouts) "
              f"at every row0 and the last shard's chunks, K8 (both twists) on every row shard "
              f"equal to plain at {', '.join(done)}", flush=True)
        with switch():
            p = sol_params(61, 20)
            plan, ops = get_plan(p), pick_ops(p.q)
            tabs = plan.device_tables(dev)
            n1, n2, dl = shard_logs(plan, 8)
            k5_k7 = launch_counts(launches_of, [f"{k}_solinas" for k in twopass.KERNELS])
            check_row_shard(p, plan, ops, tabs, 16, n1, n2, 3 << (n1 - dl), n1 - dl,
                            f"Solinas q {p.q:#x} m20 b16 D8 rows [{3 << (n1 - dl)}, "
                            f"+2^{n1 - dl})", "solinas_u64", quiet=False)
            ran = {k: launches_of[k] - n for k, n in k5_k7.items() if launches_of[k] > n}
            if set(ran) != {"fwd_rows_solinas_u64", "inv_rows_solinas_u64"}:
                raise AssertionError(f"the Solinas shard check launched {ran}")

        phase(f"the dist slice's main path: dist_fwd_ntt (strict, lazy; n_chunks 1 and 4), "
              f"dist_inv_ntt (n_chunks 1 and 4), dist_negacyclic_mul (n_chunks 1 and 4), "
              f"dist_rec_fwd_ntt / dist_rec_inv_ntt and batch_parallel_fwd on a local mesh of "
              f"{DIST_SHARDS} shards on this card, "
              + ", ".join(f"{s} batch {b}" for s, (_, b) in dist_cases.items())
              + "; dist_fwd_ntt m20 through a 1-rank NCCL world")
        mesh = dist.default_mesh(DIST_SHARDS, device=dev)
        ins = {s: (rand_dev(p, b), rand_dev(p, b)) for s, (p, b) in dist_cases.items()}
        torch.cuda.synchronize()
        launches_of.clear()
        outs = {}
        for s, (p, b) in dist_cases.items():
            x, y = ins[s]
            f = dist.dist_fwd_ntt(x, p, mesh)
            outs[s] = {
                "fwd": f, "fwd_c4": dist.dist_fwd_ntt(x, p, mesh, n_chunks=4),
                "lazy": dist.dist_fwd_ntt(x, p, mesh, lazy=True),
                "inv": dist.dist_inv_ntt(f, p, mesh),
                "inv_c4": dist.dist_inv_ntt(f, p, mesh, n_chunks=4),
                "prod": dist.dist_negacyclic_mul(x, y, p, mesh),
                "prod_c4": dist.dist_negacyclic_mul(x, y, p, mesh, n_chunks=4),
                "rec": dist.dist_rec_fwd_ntt(x, p, mesh),
                "rec_lazy": dist.dist_rec_fwd_ntt(x, p, mesh, lazy=True)}
            outs[s]["rec_inv"] = dist.dist_rec_inv_ntt(outs[s]["rec"], p, mesh)
            if b % DIST_SHARDS == 0:
                outs[s]["batch"] = dist.batch_parallel_fwd(x, p, mesh)
        torch.cuda.synchronize()
        launches8 = {k: v for k, v in launch_counts(launches_of, transform_kernels).items() if v}
        shard8 = {k: launches_of[f"shard/{k}"] for k in launch_counts(
            launches_of, (*twopass.KERNELS, "twist_mul"))}
        print(f"  launch counts of this path: {launches8}; on shards: "
              f"{ {k: v for k, v in shard8.items() if v} }", flush=True)
        need = [f"{k}_u{w}" for k in ("fwd_cols", "fwd_rows", "inv_rows", "inv_cols",
                                      "twist_mul") for w in (32, 64)]
        # each call launches K4-K8 on all DIST_SHARDS shards, all but one at row0 != 0
        few = [k for k in need if shard8[k] < DIST_SHARDS]
        idle = [k for k in ("mul_mod_u32", "mul_mod_u64", "fwd_fused_u32", "fwd_fused_u64",
                            "inv_fused_u32", "inv_fused_u64") if not launches8.get(k)]
        if few or idle:
            raise AssertionError(f"the dist path launched {few} on fewer than {DIST_SHARDS} "
                                 f"shards and never launched {idle}")
        for s, (p, b) in dist_cases.items():
            x, y = ins[s]
            o = outs[s]
            flat = api.fwd_ntt(x, p, "sixstep")
            for k in ("fwd", "fwd_c4", "rec", "batch"):
                if k in o and not torch.equal(o[k], flat):
                    raise AssertionError(f"{s}: dist {k} differs from the flat 'sixstep'")
            if not torch.equal(o["lazy"], api.fwd_ntt(x, p, "sixstep", lazy=True)):
                raise AssertionError(f"{s}: the lazy dist forward differs from the flat one")
            r = mm.to_host(o["rec_lazy"])
            if (r % np.uint64(p.q) != mm.to_host(flat)).any() or int(r.max()) >= 4 * p.q:
                raise AssertionError(f"{s}: the lazy rec dist forward is not the flat one mod q "
                                     "below 4q")
            for k in ("inv", "inv_c4", "rec_inv"):
                if not torch.equal(o[k], x):
                    raise AssertionError(f"{s}: dist {k} round trip != a")
            want = api.negacyclic_mul(x, y, p)
            for k in ("prod", "prod_c4"):
                if not torch.equal(o[k], want):
                    raise AssertionError(f"{s}: dist {k} differs from api.negacyclic_mul")
            print(f"  {s} (q {p.q:#x}) D{DIST_SHARDS}: forwards (strict, n_chunks 1 / 4, rec"
                  f"{', batch-parallel' if 'batch' in o else ''}) and the lazy one equal to the "
                  f"flat 'sixstep', rec lazy equal mod q and below 4q, products (n_chunks 1 / 4)"
                  f" equal to api.negacyclic_mul, round trips (n_chunks 1 / 4, rec) exact",
                  flush=True)
        del outs, ins
        torch.cuda.empty_cache()
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist.init_multihost(f"127.0.0.1:{port}", 1, 0, device="cuda")
        try:
            world = dist.default_mesh()
            p, b = dist_cases["m20-q62"]
            x = rand_dev(p, b)
            before = launches_of["fwd_rows_u64"]
            got = dist.dist_fwd_ntt(x, p, world)
            if launches_of["fwd_rows_u64"] == before:
                raise AssertionError("the NCCL world's forward launched no K5")
            if not torch.equal(got, api.fwd_ntt(x, p, "sixstep")):
                raise AssertionError("dist_fwd_ntt through a 1-rank NCCL world differs")
            print(f"  dist_fwd_ntt m20-q62 b{b} through a 1-rank NCCL world ({tdist.get_backend()}, "
                  f"{world}): equal to the flat 'sixstep'", flush=True)
        finally:
            tdist.destroy_process_group()

        phase(f"dist times (device time from a CUDA graph of whole calls, min over reps; "
              f"{smi}): the D = {' / '.join(map(str, DIST_TIMED_SHARDS))} compositions beside the "
              f"flat 'sixstep', the D = {DIST_SHARDS} forward's all-to-all copies, the shard "
              f"launches beside their bounds")
        rows = []
        for s, (p, b) in dist_cases.items():
            plan, ops = get_plan(p), pick_ops(p.q)
            tabs = plan.device_tables(dev)
            word = f"u{plan.word}"
            x, y = rand_dev(p, b), rand_dev(p, b)
            f = api.fwd_ntt(x, p, "sixstep")
            meshes = {nd: dist.default_mesh(nd, device=dev) for nd in DIST_TIMED_SHARDS}
            us = {"flat fwd": lab.cuda_us(lambda v: api.fwd_ntt(v, p, "sixstep"), x, 3, 5),
                  "flat inv": lab.cuda_us(lambda v: api.inv_ntt(v, p, "sixstep"), f, 3, 5),
                  "flat product": lab.cuda_us(lambda v: api.negacyclic_mul(v, y, p), x, 3, 5)}
            for nd, m_ in meshes.items():
                us[f"D{nd} fwd"] = lab.cuda_us(lambda v: dist.dist_fwd_ntt(v, p, m_), x, 3, 5)
                us[f"D{nd} inv"] = lab.cuda_us(lambda v: dist.dist_inv_ntt(v, p, m_), f, 3, 5)
                us[f"D{nd} product"] = lab.cuda_us(
                    lambda v: dist.dist_negacyclic_mul(v, y, p, m_), x, 3, 5)
                us[f"D{nd} rec fwd"] = lab.cuda_us(lambda v: dist.dist_rec_fwd_ntt(v, p, m_),
                                                    x, 3, 5)
            # the D-shard forward's pieces: K4 and K5 on one shard, and the
            # all-to-all with its copies on either side, for all D shards
            nd = DIST_SHARDS
            n1, n2, dl = shard_logs(plan, nd)
            r, lanes = 1 << (n1 - dl), 1 << (n2 - dl)
            (_, line), = meshes[nd].lines("x")
            cols = [rand_words(p, b, (1 << n1) * lanes, 4) for _ in range(nd)]

            def exchange(v):
                sends = [c.view(b, nd, r, lanes).transpose(0, 1).contiguous() for c in v]
                return [z.permute(1, 2, 0, 3).reshape(b, -1) for z in line.all_to_all(sends)]

            us[f"D{nd} fwd all-to-all copies"] = lab.cuda_us(exchange, cols, 3, 5)
            row0 = 3 * r
            xr = rand_words(p, b, r << n2, 4)
            yr = rand_words(p, b, r << n2)
            xc = cols[0]
            yc = rand_words(p, b, (1 << n1) * lanes)
            l1 = dist._rec_l1_for(plan, nd)
            r8 = (1 << l1) >> dl
            x8 = rand_words(p, b, r8 << (p.m - l1), 4)
            tw8 = tuple(t[3 * r8:4 * r8] for t in tabs.twist(l1, False))
            runs = {
                "fwd_cols": (n1, lambda: twopass.fwd_cols(xc, plan, n1, n2_log=n2 - dl),
                             lambda: sixstep.fwd_cols(xc, ops, tabs.w, tabs.w_con, p.q, n1)),
                "fwd_rows": (n1, lambda: twopass.fwd_rows(xr, plan, n1, True, False, row0,
                                                          n1 - dl),
                             lambda: sixstep.fwd_rows(xr, ops, tabs.w, tabs.w_con, p.q, n1, True,
                                                      False, row0, n1 - dl)),
                "inv_rows": (n1, lambda: twopass.inv_rows(yr, plan, n1, False, row0, n1 - dl),
                             lambda: sixstep.inv_rows(yr, ops, tabs.w_inv, tabs.w_inv_con, p.q,
                                                      n1, False, row0, n1 - dl)),
                "inv_cols": (n1, lambda: twopass.inv_cols(yc, plan, n1, n2_log=n2 - dl),
                             lambda: sixstep.inv_cols(yc, ops, tabs.w_inv, tabs.w_inv_con,
                                                      *plan.inv_consts, p.q, n1)),
                "twist_mul": (l1, lambda: rec.twist_mul(x8, plan, l1, False, 3 * r8, l1 - dl),
                              lambda: sixstep.twist_mul(x8, ops, tw8, p.q)),
            }
            parts = []
            for kernel, (split, kern, plain) in runs.items():
                k_ms, p_ms = kernel_in_turns(torch, lab, kern, plain, 2)
                b_ms, b_by = bound(*kernel_work(kernel, p.m, split, b, plan.word, parts=nd))
                name = f"{kernel}_shard_{word}"
                parts.append(f"{kernel} {k_ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f}, "
                             f"{b_ms / k_ms:.0%}; plain {p_ms * 1e3:.1f})")
                rows.append({"name": name, "route": "cuda", "source": SOURCES[kernel],
                             "replaces": REPLACES[kernel],
                             "launches": shard8[f"{kernel}_{word}"],
                             "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
                             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                             "shape": f"{s} batch {b}, one of {nd} shards"})
            print(f"  {s} b{b}: " + ", ".join(f"{k} {v:.1f} us" for k, v in us.items()),
                  flush=True)
            print(f"  {s} b{b}, one of {nd} shards (n1_log {n1}; K8 at N1 = 2^{l1}): "
                  + ", ".join(parts), flush=True)
            del x, y, f, cols, xr, yr, yc, x8
            torch.cuda.empty_cache()
        return rows


    sol_rows = solinas_slice()
    dist_rows = dist_slice()

    phase(f"times (kernels from a CUDA graph of launches, plain versions and API calls "
          f"between CUDA events; min over reps; {smi})")
    table = []

    def entry(name, count, k_ms, p_ms, m, n1_log, batch, word, shape, record,
              library_ms=None, plain_shape=None):
        """Print one kernel time beside its bound; with record, add it to the
        kernel table."""
        base = name.rsplit("_", 1)[0].removesuffix("_solinas")
        b_ms, b_by = bound(*kernel_work(base, m, n1_log, batch, word, "_solinas_" in name))
        lib = "" if library_ms is None else f", library {library_ms * 1e3:.1f} us"
        print(f"  {name} {shape}: kernel {k_ms * 1e3:.1f} us, plain {p_ms * 1e3:.1f} us"
              f"{f' ({plain_shape})' if plain_shape else ''}{lib}, bound {b_ms * 1e3:.1f} us "
              f"({b_by}; {b_ms / k_ms:.0%} of it)", flush=True)
        if record:
            row = {"name": name, "route": "cuda", "source": SOURCES[base],
                   "replaces": REPLACES[base], "launches": count, "max_abs_err": errs[name],
                   "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": library_ms, "shape": shape}
            if plain_shape:
                row["plain_shape"] = plain_shape
            table.append(row)

    for case in CASES:
        p = params[case]
        plan, ops = get_plan(p), pick_ops(p.q)
        tabs = plan.device_tables(dev)
        inv_c = plan.inv_consts
        word = f"u{plan.word}"
        x, y = he[case]
        fx = fused.fwd_fused(x, plan)
        small = rt[case]
        k_ms, p_ms = in_turns(
            torch, lambda: fused.fwd_fused(small, plan),
            lambda: sixstep.fwd_sixstep(small, ops, tabs.w, tabs.w_con, p.q), 20, 3)
        print(f"  {case} K1 fwd_fused batch {BATCH_CHECK}: kernel {k_ms * 1e3:.1f} us "
              f"({BATCH_CHECK / k_ms * 1e3:,.0f} transforms/s), plain {p_ms * 1e3:.1f} us "
              f"({BATCH_CHECK / p_ms * 1e3:,.0f} transforms/s)", flush=True)
        runs = {
            f"fwd_fused_{word}": (lambda: fused.fwd_fused(x, plan),
                                  lambda: sixstep.fwd_sixstep(x, ops, tabs.w, tabs.w_con, p.q)),
            f"inv_fused_{word}": (lambda: fused.inv_fused(fx, plan),
                                  lambda: sixstep.inv_sixstep(fx, ops, tabs.w_inv,
                                                              tabs.w_inv_con, *inv_c, p.q)),
            f"mul_mod_{word}": (lambda: pointwise.mul_mod(x, y, p.q),
                                lambda: ops.mul_mod(x, y, p.q)),
        }
        for name, (kern, plain) in runs.items():
            k_ms, p_ms = kernel_in_turns(torch, lab, kern, plain, 2)
            entry(name, launches[name], k_ms, p_ms, p.m, p.m, BATCH_HE, plan.word,
                  f"m14 batch {BATCH_HE}", record=True)
        k_ms, p_ms = in_turns(torch, lambda: api.negacyclic_mul(x, y, p),
                              lambda: plain_product(p, x, y), 5, 2)
        print(f"  {case} negacyclic_mul batch {BATCH_HE}: kernels {k_ms * 1e3:.1f} us "
              f"({BATCH_HE / k_ms * 1e3:,.0f} products/s), plain {p_ms * 1e3:.1f} us "
              f"({BATCH_HE / p_ms * 1e3:,.0f} products/s)", flush=True)

    # the m14 q62 forward at batch 1024 through both forms, for 'auto'
    p = params["q62"]
    x = he["q62"][0]
    k_ms, s_ms = in_turns(torch, lambda: api.fwd_ntt(x, p, "pallas-fused"),
                          lambda: api.fwd_ntt(x, p, "sixstep"), 10, 10)
    print(f"  q62 m14 fwd_ntt batch {BATCH_HE}: pallas-fused (K1) {k_ms * 1e3:.1f} us, "
          f"sixstep (K4 + K5) {s_ms * 1e3:.1f} us", flush=True)
    del he, rt

    # K1 / K2 at every m from 10 up, 2^24 words a call, beside their bounds;
    # device time from a CUDA graph of launches, as the lab times (a lone
    # call between two events can include the host's enqueue)
    for word in (64, 32):
        for m, p in every_m(word):
            if m < 10:
                continue
            plan = get_plan(p)
            batch = WORDS_PER_M >> m
            a = rand(p, batch)
            f = fused.fwd_fused(a, plan)
            k1_ms = lab.cuda_us(lambda x: fused.fwd_fused(x, plan), a, 3, lab.INNER) / 1e3
            k2_ms = lab.cuda_us(lambda x: fused.inv_fused(x, plan), f, 3, lab.INNER) / 1e3
            b1, _ = bound(*kernel_work("fwd_fused", m, m, batch, word))
            b2, _ = bound(*kernel_work("inv_fused", m, m, batch, word))
            print(f"  w{word} m{m} batch {batch}: K1 {k1_ms * 1e3:.1f} us (bound "
                  f"{b1 * 1e3:.1f}, {b1 / k1_ms:.0%}), K2 {k2_ms * 1e3:.1f} us (bound "
                  f"{b2 * 1e3:.1f}, {b2 / k2_ms:.0%})", flush=True)
            del a, f

    # K4-K7 at every m of the two-pass sweep, 2^24 words a call, beside their
    # bounds; device time from a CUDA graph of launches
    for word in (64, 32):
        for m, p, n1 in two_pass_m(word):
            plan = get_plan(p)
            batch = WORDS_PER_M >> m
            a = rand(p, batch)
            c = twopass.fwd_cols(a, plan, n1)
            f = twopass.fwd_rows(c, plan, n1)
            r = twopass.inv_rows(f, plan, n1)
            parts = []
            for k, name, fn, x in (
                    ("K4", "fwd_cols", lambda x: twopass.fwd_cols(x, plan, n1), a),
                    ("K5", "fwd_rows", lambda x: twopass.fwd_rows(x, plan, n1), c),
                    ("K6", "inv_rows", lambda x: twopass.inv_rows(x, plan, n1), f),
                    ("K7", "inv_cols", lambda x: twopass.inv_cols(x, plan, n1), r)):
                k_ms = lab.cuda_us(fn, x, 3, lab.INNER) / 1e3
                b_ms, _ = bound(*kernel_work(name, m, n1, batch, word))
                parts.append(f"{k} {k_ms * 1e3:.1f} us (bound {b_ms * 1e3:.1f}, "
                             f"{b_ms / k_ms:.0%})")
            print(f"  w{word} m{m} batch {batch} (n1_log {n1}): {', '.join(parts)}", flush=True)
            del a, c, f, r
        torch.cuda.empty_cache()

    for size, batch in TWO_PASS:
        p, plan, ops, tabs, n1, word = two_pass_ops(size)
        a = rand(p, batch)
        c = twopass.fwd_cols(a, plan, n1)
        f = twopass.fwd_rows(c, plan, n1)
        r = twopass.inv_rows(f, plan, n1)
        consts = plan.inv_consts
        runs = {
            f"fwd_cols_{word}": (lambda: twopass.fwd_cols(a, plan, n1),
                                 lambda: sixstep.fwd_cols(a, ops, tabs.w, tabs.w_con, p.q,
                                                          n1)),
            f"fwd_rows_{word}": (lambda: twopass.fwd_rows(c, plan, n1),
                                 lambda: sixstep.fwd_rows(c, ops, tabs.w, tabs.w_con, p.q,
                                                          n1)),
            f"inv_rows_{word}": (lambda: twopass.inv_rows(f, plan, n1),
                                 lambda: sixstep.inv_rows(f, ops, tabs.w_inv,
                                                          tabs.w_inv_con, p.q, n1)),
            f"inv_cols_{word}": (lambda: twopass.inv_cols(r, plan, n1),
                                 lambda: sixstep.inv_cols(r, ops, tabs.w_inv,
                                                          tabs.w_inv_con, *consts, p.q, n1)),
        }
        main_size = size.startswith("m16")
        for name, (kern, plain) in runs.items():
            k_ms, p_ms = kernel_in_turns(torch, lab, kern, plain, 2)
            entry(name, launches2[name], k_ms, p_ms, p.m, n1, batch, plan.word,
                  f"{size} batch {batch}", record=main_size)
        # the product's K5 and K6 keep the transposed layout between them
        ft = twopass.fwd_rows(c, plan, n1, keep_transposed=True)
        runs = {
            f"fwd_rows_{word}": (
                lambda: twopass.fwd_rows(c, plan, n1, keep_transposed=True),
                lambda: sixstep.fwd_rows(c, ops, tabs.w, tabs.w_con, p.q, n1, True, True)),
            f"inv_rows_{word}": (
                lambda: twopass.inv_rows(ft, plan, n1, input_transposed=True),
                lambda: sixstep.inv_rows(ft, ops, tabs.w_inv, tabs.w_inv_con, p.q, n1, True)),
        }
        for name, (kern, plain) in runs.items():
            k_ms, p_ms = kernel_in_turns(torch, lab, kern, plain, 2)
            entry(name, launches2[name], k_ms, p_ms, p.m, n1, batch, plan.word,
                  f"{size} batch {batch}, the transposed layout", record=False)
        if main_size:
            x, y = he2[size]
            k_ms, p_ms = kernel_in_turns(torch, lab, lambda: pointwise.mul_mod(x, y, p.q),
                                         lambda: ops.mul_mod(x, y, p.q), 2)
            entry(f"mul_mod_{word}", launches2[f"mul_mod_{word}"], k_ms, p_ms, p.m, n1,
                  batch, plan.word, f"{size} batch {batch}", record=False)
            k_ms, p_ms = in_turns(torch, lambda: api.negacyclic_mul(x, y, p),
                                  lambda: plain_product(p, x, y), 5, 2)
            b_ms = sum(bound(*kernel_work(k, p.m, n1, batch, plan.word))[0] * n
                       for k, n in (("fwd_cols", 2), ("fwd_rows", 2), ("mul_mod", 1),
                                    ("inv_rows", 1), ("inv_cols", 1)))
            print(f"  {size} negacyclic_mul batch {batch}: kernels {k_ms * 1e3:.1f} us "
                  f"({batch / k_ms * 1e3:,.0f} products/s), plain {p_ms * 1e3:.1f} us, "
                  f"sum of the seven launches' bounds {b_ms * 1e3:.1f} us", flush=True)
        del a, c, f, r, ft
        torch.cuda.empty_cache()

    # K8 at the rec path's round-trip shapes from a CUDA graph, beside its
    # bound; its plain version between CUDA events
    for w, m in REC_ROUND_TRIPS:
        p = params_at(m, w)
        plan, ops, l1 = get_plan(p), pick_ops(p.q), sixstep.rec_split(m)
        x = rand_dev(p, 1, lazy=True)
        tw = plan.device_tables(dev).twist(l1, False)
        k_ms, p_ms = kernel_in_turns(torch, lab, lambda: rec.twist_mul(x, plan, l1),
                                     lambda: sixstep.twist_mul(x, ops, tw, p.q), 2)
        entry(f"twist_mul_u{w}", launches4[f"twist_mul_u{w}"], k_ms, p_ms, m, l1, 1, w,
              f"m{m} batch 1", record=True)
        del x

    # 'sixstep-rec' against the flat 'sixstep', forward and inverse, one API
    # call two ways: its device time from a CUDA graph, and its time in a
    # stream of back-to-back calls between two CUDA events, which includes
    # the host's launches (a server's view); each in turns flat, rec, rec,
    # flat, the spread the larger of the two forms' differences between
    # passes.  Inputs are drawn on the card (seeded), as timing needs no
    # host copy of them.
    def stream_us(fn, x, calls=20):
        for _ in range(2):
            fn(x)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(calls):
            fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / calls

    def graph_us(graph, inner=5, reps=2):
        """Device time of one call from replays of a graph of `inner` calls."""
        best = float("inf")
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3 / inner)
        return best

    def captured(fn, x, inner=5):
        """A CUDA graph of `inner` calls, after two warm-up calls."""
        for _ in range(2):
            fn(x)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(inner):
                fn(x)
        graph.replay()
        return graph

    def rec_against_flat(p, x, inverse):
        call = api.inv_ntt if inverse else api.fwd_ntt
        fns = {v: (lambda t, v=v: call(t, p, v)) for v in ("sixstep", "sixstep-rec")}
        graphs = {v: captured(fn, x) for v, fn in fns.items()}
        out = {}
        for how, timer in (("graph", lambda v: graph_us(graphs[v])),
                           ("stream", lambda v: stream_us(fns[v], x))):
            flat1, rec1 = timer("sixstep"), timer("sixstep-rec")
            rec2, flat2 = timer("sixstep-rec"), timer("sixstep")
            spread = max(abs(rec1 - rec2), abs(flat1 - flat2))
            out[how] = {"rec_us": min(rec1, rec2), "flat_us": min(flat1, flat2),
                        "spread_us": spread,
                        "rec_wins": min(flat1, flat2) - min(rec1, rec2) > spread}
        del graphs
        return out

    rec_rows = []
    for w in (64, 32):
        for m in REC_TIMED_M:
            p = params_at(m, w)
            batches = (1, 8, 128) if m <= REC_TIMED_BATCH128_LAST_M else (1, 8)
            for batch in REC_TIMED_M17_BATCHES if m == 17 else batches:
                x = rand_dev(p, batch)
                f = api.fwd_ntt(x, p, "sixstep")
                row = {"word": w, "m": m, "batch": batch}
                for d, arg in (("fwd", x), ("inv", f)):
                    row[d] = rec_against_flat(p, arg, d == "inv")
                rec_rows.append(row)
                print(f"  w{w} m{m} batch {batch}: " + "; ".join(
                    f"{d} {how} rec {t['rec_us']:.1f} / flat {t['flat_us']:.1f} us "
                    f"(spread {t['spread_us']:.1f}{', rec faster' if t['rec_wins'] else ''})"
                    for d in ("fwd", "inv") for how, t in row[d].items()), flush=True)
                del x, f
            torch.cuda.empty_cache()
    print(f"  rec against flat: {json.dumps(rec_rows)}", flush=True)
    wins = [(r["word"], r["m"], r["batch"]) for r in rec_rows
            if all(r[d][how]["rec_wins"] for d in ("fwd", "inv") for how in ("graph", "stream"))]
    print(f"  (word, m, batch) where sixstep-rec is faster both ways, in both views: {wins}; "
          f"api.REC_CELLS {api.REC_CELLS}", flush=True)

    # the serving handle's and the tower's products at batch 1024
    k_ms, a_ms = in_turns(torch, lambda: ctx.negacyclic(*hx_dev),
                          lambda: api.negacyclic_mul(*hx_dev, p14), 5, 5)
    g_ms = lab.cuda_us(lambda _: ctx.negacyclic(*hx_dev), None, 3, 5) / 1e3
    print(f"  DeviceNtt q62 m14 negacyclic batch {BATCH_HE}: {k_ms * 1e3:.1f} us between events "
          f"({BATCH_HE / k_ms * 1e3:,.0f} products/s), {g_ms * 1e3:.1f} us from a CUDA graph; "
          f"api.negacyclic_mul {a_ms * 1e3:.1f} us", flush=True)
    t_ms = cuda_ms(torch, lambda: tower.negacyclic(*tx_dev), 5)
    tg_ms = lab.cuda_us(lambda _: tower.negacyclic(*tx_dev), None, 3, 5) / 1e3
    print(f"  DeviceRnsTower {len(TOWER_BITS)} x 30-bit m14 negacyclic batch {BATCH_HE}: "
          f"{t_ms * 1e3:.1f} us between events ({BATCH_HE / t_ms * 1e3:,.0f} ciphertext "
          f"products/s), {tg_ms * 1e3:.1f} us from a CUDA graph", flush=True)
    del hx_dev, tx_dev
    torch.cuda.empty_cache()


    # the reference-family variants: each one's forward and product at m14
    # batch 1024 against K1's and 'auto''s (device time from a CUDA graph);
    # K9 / K10 a stage beside their bounds, their plain versions at batch 32
    # between CUDA events; radix2 and radix4-u32 against pallas-fused at m6-m8
    # in a graph and in a stream of 20 calls, for 'auto'
    fam_rows = []
    for name, bits in FAMILY_HE:
        p, x, y = he5[bits]
        f_us = lab.cuda_us(lambda t: api.fwd_ntt(t, p, name), x, 3, 5)
        k1_us = lab.cuda_us(lambda t: api.fwd_ntt(t, p, "pallas-fused"), x, 3, 5)
        m_us = lab.cuda_us(lambda _: api.negacyclic_mul(x, y, p, variant=name), None, 3, 3)
        a_us = lab.cuda_us(lambda _: api.negacyclic_mul(x, y, p), None, 3, 3)
        fam_rows.append({"variant": name, "q": hex(p.q), "fwd_us": f_us, "k1_fwd_us": k1_us,
                         "product_us": m_us, "auto_product_us": a_us})
        print(f"  {name} q {p.q:#x} m14 batch {BATCH_HE}: forward {f_us:.1f} us (K1 "
              f"{k1_us:.1f}), product {m_us:.1f} us ('auto' {a_us:.1f})", flush=True)
    print(f"  variant times: {json.dumps(fam_rows)}", flush=True)
    for name, (kern, plain, x, args, lt, word) in stage_cases.items():
        small = x[:LAB_BATCH_CHECK].contiguous()
        k_ms, p_ms = kernel_in_turns(torch, lab, lambda: kern(x, *args),
                                     lambda: plain(small, *args), 2)
        entry(name, launches5[name], k_ms, p_ms, 14, lt, BATCH_HE, 32 if word == 32 else 64,
              f"m14 batch {BATCH_HE}, one stage (lt {lt})", record=True,
              plain_shape=f"m14 batch {LAB_BATCH_CHECK}")
    small_rows = []
    for m in FAMILY_SMALL_M:
        for name, p in (("radix2", bench_params(m, 62)), ("radix4-u32", NttParams.generate(27, m))):
            for batch in FAMILY_SMALL_BATCHES:
                x = rand(p, batch)
                row = {"m": m, "q": hex(p.q), "batch": batch}
                for v in (name, "pallas-fused"):
                    row[v] = {"graph_us": lab.cuda_us(lambda u, v=v: api.fwd_ntt(u, p, v), x, 3, 5),
                              "stream_us": stream_us(lambda u, v=v: api.fwd_ntt(u, p, v), x)}
                small_rows.append(row)
                print(f"  m{m} batch {batch}: {name} " + ", ".join(
                    f"{v} graph {row[v]['graph_us']:.1f} / stream {row[v]['stream_us']:.1f} us"
                    for v in (name, "pallas-fused")), flush=True)
    print(f"  small-m forwards for 'auto': {json.dumps(small_rows)}", flush=True)
    del he5, stage_cases
    torch.cuda.empty_cache()

    # the mxu slice (q = 0xfff0001 at m14, the largest 28-bit NTT prime of N at
    # m16 / m20): K11 a launch of each contract as a transform's first pass
    # runs it (left: the forward's, scaled by T; right: the inverse's, scaled
    # by S) from a CUDA graph beside its bound, its plain version between CUDA
    # events, and torch._int_mm's four calls on the same int8 operands (the 16
    # limb products on the limbs concatenated as JAX batches them) as a
    # yardstick of the tensor-core part alone, never called by the port; the
    # mxu forward, inverse and product beside K1 (word 32, where it serves)
    # and 'auto', one API call's device time from a CUDA graph
    def int_mm_ms(mat, x, contract):
        limbs = [((x >> (7 * s)) & 127).to(torch.int8) for s in range(4)]
        if contract == "left":  # (K, K) @ (K, 4 F) of every polynomial, side by side
            rhs = torch.cat(limbs, dim=-1).transpose(0, 1).reshape(x.shape[1], -1).contiguous()
            calls = [(mat[s].contiguous(), rhs) for s in range(4)]
        else:  # (4 N1 of every polynomial, K) @ (K, K)^T
            lhs = torch.cat(limbs, dim=-2).reshape(-1, x.shape[-1]).contiguous()
            calls = [(lhs, mat[s].t().contiguous()) for s in range(4)]
        return lab.cuda_us(lambda _: [torch._int_mm(a, b) for a, b in calls], None, 3, 5) / 1e3

    mxu_rows = []
    for m, batch in MXU_TIMED:
        p = mxu_params(m)
        plan = get_plan(p)
        x, y = rand_dev(p, batch), rand_dev(p, batch)
        f = api.fwd_ntt(x, p, "mxu")
        ft, it = plan.device_tables(dev).mxu(False), plan.device_tables(dev).mxu(True)
        n1, n2 = 1 << ft["n1_log"], p.n >> ft["n1_log"]
        passes = {"left": (ft["m1"], x.view(batch, n1, n2), (ft["t"], ft["t_con"]), n1),
                  "right": (it["w2i"], f.view(batch, n1, n2), (it["s"], it["s_con"]), n2)}
        row = {"m": m, "batch": batch, "q": hex(p.q)}
        for contract, (mat, arg, scale, k) in passes.items():
            k_ms, p_ms = kernel_in_turns(
                torch, lab, lambda: mxu.limb_matmul(mat, arg, p.q, contract, scale),
                lambda: mxu.limb_matmul_plain(mat, arg, p.q, contract, scale), 2)
            entry(f"limb_matmul_{contract}", launches6[f"limb_matmul_{contract}"], k_ms, p_ms, m,
                  k.bit_length() - 1, batch, 32, f"m{m} batch {batch}, scaled", record=m == 14)
            row[f"k11_{contract}_us"] = k_ms * 1e3
            row[f"int_mm_{contract}_us"] = int_mm_ms(mat, arg, contract) * 1e3
        print(f"  m{m} batch {batch}: torch._int_mm, 4 calls on K11's int8 operands (the "
              f"tensor-core part alone): left {row['int_mm_left_us']:.1f} us, right "
              f"{row['int_mm_right_us']:.1f} us", flush=True)
        for d, fn, arg in (("fwd", lambda t, v: api.fwd_ntt(t, p, v), x),
                           ("inv", lambda t, v: api.inv_ntt(t, p, v), f)):
            for v in ("mxu", "auto"):
                row[f"{v}_{d}_us"] = lab.cuda_us(lambda t: fn(t, v), arg, 3, 5)
        for v in ("mxu", "auto"):
            row[f"{v}_product_us"] = lab.cuda_us(
                lambda _: api.negacyclic_mul(x, y, p, variant=v), None, 3, 3)
        if m <= fused.max_logn(32):
            row["k1_fwd_us"] = lab.cuda_us(lambda t: fused.fwd_fused(t, plan), x, 3, 5)
        mxu_rows.append(row)
        print(f"  mxu m{m} batch {batch} q {p.q:#x}: forward {row['mxu_fwd_us']:.1f} us ('auto' "
              f"{row['auto_fwd_us']:.1f}" + (f", K1 {row['k1_fwd_us']:.1f}" if "k1_fwd_us" in row
                                             else "") + f"), inverse {row['mxu_inv_us']:.1f} "
              f"('auto' {row['auto_inv_us']:.1f}), product {row['mxu_product_us']:.1f} ('auto' "
              f"{row['auto_product_us']:.1f}); mxu / auto forward "
              f"{row['mxu_fwd_us'] / row['auto_fwd_us']:.2f}", flush=True)
        del x, y, f, passes
        torch.cuda.empty_cache()
    print(f"  mxu times: {json.dumps(mxu_rows)}", flush=True)

    # the lab's kernels at the lab's shape, timed as the lab times them (a
    # CUDA graph of launches); their plain versions at batch 32; the one
    # PyTorch call that computes a probe's function, where there is one
    lab_batch = 512
    library = {"diag_copy": lambda v: v.clone(), "diag_moves": lambda v: v.flip(-1)}
    for case in lab_cases:
        p = lab_params[case]
        plan = get_plan(p)
        word = f"u{plan.word}"
        x = rand(p, lab_batch)
        small = x[:LAB_BATCH_CHECK].contiguous()
        cands = lab.candidates(plan, lab_n1)
        k1_ms = lab.cuda_us(cands["v1"].fn, x, 5, lab.INNER) / 1e3
        parts, lib_times = {}, {}
        for cand_name, cand in cands.items():
            if cand_name in ("v1", "i1"):
                continue
            # plain, kernel, kernel, plain
            p1 = cuda_ms(torch, lambda: cand.plain(small), 2)
            k_ms = min(lab.cuda_us(cand.fn, x, 5, lab.INNER) for _ in range(2)) / 1e3
            p_ms = min(p1, cuda_ms(torch, lambda: cand.plain(small), 2))
            lib = library.get(cand.kernel)
            lib_ms = None if lib is None else lab.cuda_us(lib, x, 5, lab.INNER) / 1e3
            lib_times[cand_name] = lib_ms
            entry(f"{cand.kernel}_{word}", launches3[f"{cand.kernel}_{word}"], k_ms, p_ms,
                  p.m, lab_n1, lab_batch, plan.word, f"m14 batch {lab_batch}", record=True,
                  library_ms=lib_ms, plain_shape=f"m14 batch {LAB_BATCH_CHECK}")
            parts[cand_name] = k_ms
        print(f"  {case} m14 batch {lab_batch}: K1 {k1_ms * 1e3:.1f} us against "
              + ", ".join(f"{k} {v * 1e3:.1f} us" for k, v in parts.items()), flush=True)
        k1_again = lab.cuda_us(cands["v1"].fn, x, 5, lab.INNER) / 1e3
        k1_best = min(k1_ms, k1_again)
        split = lab.k1_split(k1_best, parts["diag-copy"], parts["diag-moves"],
                             parts["diag-math"])
        k1_bound = bound(*kernel_work("fwd_fused", p.m, p.m, lab_batch, plan.word))[0]
        data_bound = bound(*kernel_work("diag_copy", p.m, p.m, lab_batch, plan.word))[0]
        print(f"  {case} K1's split at m14 batch {lab_batch} ({smi}): K1 {k1_best * 1e3:.1f} us "
              f"(before / after the probes {k1_ms * 1e3:.1f} / {k1_again * 1e3:.1f}; bound "
              f"{k1_bound * 1e3:.1f}) = " + " + ".join(f"{k} {v * 1e3:.1f} us"
                                                       for k, v in split.items())
              + f"; diag_copy {parts['diag-copy'] * 1e3:.1f} against clone() "
              f"{lib_times['diag-copy'] * 1e3:.1f}, diag_moves {parts['diag-moves'] * 1e3:.1f} "
              f"against flip(-1) {lib_times['diag-moves'] * 1e3:.1f}; bound of each "
              f"{data_bound * 1e3:.1f} us", flush=True)
        # one more step of the arithmetic probes, free of their memory path:
        # the marginal multiply rate (against the bound's) and butterfly rate
        note(f"diag_mul_{word}", probes.diag_mul(small, 4 * N_MULTS),
             probes.plain_mul(small, 4 * N_MULTS), f"{case} diag_mul, {4 * N_MULTS} steps",
             quiet=True)
        note(f"diag_math_{word}", probes.diag_math(small, plan, 2 * p.m),
             probes.plain_math(small, plan, 2 * p.m), f"{case} diag_math, {2 * p.m} rounds",
             quiet=True)
        rates = lab.marginal_rates(plan, x)
        clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                                 "--format=csv,noheader"], capture_output=True, text=True,
                                timeout=60).stdout.strip()
        per_bfly = probe_sass[f"diag_math_u{plan.word}"]["instructions"] / 8
        warp_ips = rates["bfly_per_s"] * per_bfly / 32
        print(f"  {case} marginal rates at m14 batch {lab_batch} ({smi}; SM clock now, max: "
              f"{clocks}): diag_mul {N_MULTS} / {4 * N_MULTS} steps "
              f"{rates['mul_us'][0]:.1f} / {rates['mul_us'][1]:.1f} us, "
              f"{rates['mul_per_s']:.4g} 32-bit multiplies/s "
              f"({rates['mul_per_s'] / INT_MULS_PER_S:.0%} of the bound's {INT_MULS_PER_S:.4g}); "
              f"diag_math {p.m} / {2 * p.m} rounds {rates['math_us'][0]:.1f} / "
              f"{rates['math_us'][1]:.1f} us, {rates['bfly_per_s']:.4g} butterflies/s, "
              f"{per_bfly:.1f} SASS instructions each in its loop: {warp_ips:.4g} warp "
              f"instructions/s ({warp_ips / WARP_ISSUE_PER_S:.0%} of 4 a clock on each SM at "
              f"1.98 GHz)", flush=True)
        del x, small
    table.extend(sol_rows)
    table.extend(dist_rows)

    phase(f"the bench: python -m ntt_tpu_torch bench {' '.join(BENCH_ARGS)} and --suite --only "
          f"one body a kernel family at q62 and q27 (subprocesses); the headline against a CUDA "
          f"graph of the same call; the suite bodies (batch {BENCH_CHECK_BATCH}) against their "
          "plain versions, every launch count set to 0 before them")

    def bench_cli(*extra):
        """(the JSON line, stderr) of one bench run, which must exit 0 with
        exactly one line and no degraded."""
        out = subprocess.run([sys.executable, "-m", "ntt_tpu_torch", "bench", *BENCH_ARGS,
                              *extra], cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
        if out.returncode != 0 or len(lines) != 1 or "degraded" in lines[0] \
                or not lines[0]["value"] > 0 or lines[0]["vs_baseline"] is None:
            print(out.stdout[-4000:], out.stderr[-8000:], flush=True)
            raise AssertionError(f"bench {' '.join(extra)}: exit {out.returncode}, JSON lines "
                                 f"{lines}")
        return lines[0], out.stderr

    line, err = bench_cli()
    for ln in err.splitlines():
        if ln.startswith(("bench:", "roofline:")):
            print(f"  {ln}", flush=True)
    p = bench_params(14, 62)
    x = bench.bench_input(p, 128, dev)
    g_us = lab.cuda_us(bench.headline_call(p, None, dev), x, 5, 200)
    want = 128 / g_us * 1e6
    print(f"  headline line {json.dumps(line)}; api.fwd_ntt m14 q62 batch 128 from a CUDA graph "
          f"of 200 calls in this process: {g_us:.1f} us, {want:,.1f} transforms/s "
          f"({line['value'] / want - 1:+.1%}; {smi})", flush=True)
    if abs(line["value"] / want - 1) > BENCH_TOLERANCE:
        raise AssertionError(f"the bench's value {line['value']} is not within "
                             f"{BENCH_TOLERANCE:.0%} of {want:.1f}")
    del x
    with tempfile.TemporaryDirectory() as tmp:
        for bits, names in BENCH_SUITE.items():
            path = pathlib.Path(tmp) / f"suite_q{bits}.json"
            line, err = bench_cli("--q-bits", str(bits), "--suite", "--suite-json", str(path),
                                  "--only", ",".join(names))
            rows = json.loads(path.read_text())["variants"]
            slow = {n: r for n, r in rows.items() if not r.get("us_per_transform", 0) > 0}
            if sorted(rows) != sorted(names) or slow:
                raise AssertionError(f"suite q{bits}: rows {sorted(rows)}, not timed {slow}")
            print(f"  suite q{bits} m14 batch 128 ({smi}): " + ", ".join(
                f"{n} {r['us_per_transform']} us" for n, r in sorted(rows.items()))
                + f"; its headline {json.dumps(line)}", flush=True)
    calls = {}
    for bits, names in BENCH_SUITE.items():
        p = bench_params(14, bits)
        bodies = bench.suite_bodies(get_plan(p))
        for name in names:
            if isinstance(bodies[name], str):
                raise AssertionError(f"suite body {name} refused at q{bits}: {bodies[name]}")
            fn, word = bodies[name]
            calls[name] = fn, bench.bench_input(p, BENCH_CHECK_BATCH, dev, wide=word == 64)
    torch.cuda.synchronize()
    launches_of.clear()
    outs, per_body = {}, {}
    for name, (fn, x) in calls.items():
        before = shoup_launches()
        outs[name] = fn(x)
        per_body[name] = {k: v - before[k] for k, v in shoup_launches().items() if v > before[k]}
    torch.cuda.synchronize()
    launches8 = shoup_launches()
    print(f"  launches of each suite body: {json.dumps(per_body)}", flush=True)
    idle = [k for k, v in launches8.items() if v == 0 and k != "r4_stage_w56"]
    if idle:
        raise AssertionError(f"kernels never launched by the suite bodies: {idle}")
    for name, (fn, x) in calls.items():
        if not torch.equal(outs[name].cpu(), fn(x.cpu())):
            raise AssertionError(f"suite body {name}: differs from its plain version")
    print(f"  {', '.join(calls)}: one call each on the card equals its plain version on the "
          f"CPU (m14 batch {BENCH_CHECK_BATCH}); together they launched {launches8}", flush=True)
    del calls, outs
    torch.cuda.empty_cache()
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ntt_tpu"))
    if bad:
        raise AssertionError(f"imported {bad}")
    print(f"  wall clock a phase, s: {json.dumps(clock.seconds())}", flush=True)

    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
