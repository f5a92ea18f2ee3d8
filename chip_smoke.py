#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the kernel library from ``particlesimulation_tpu_torch/csrc`` and
holds each kernel against its plain torch version at the tile shapes the
engines give it and on the adversarial tiles of
``ops/cuda/adversarial.py`` (the cases the kernels' compaction, x buckets
and O(n) count risk); then it drives the three engines through ``Engine``:

* resident (the main path): golden vector s1 (seed 1, side 5000, ncside
  100, N=1e6) against the reference's golden values, once with the default
  pair kernel and once with the v1 kernel; the fused kernel on the tiles
  the engine's own run hands its pair pass (v4 with collide on and off, v1;
  checked, timed, with the bound);
* dense: golden s1 again, and both dense kernels on the engine's own tiles
  (checked, timed, with the bound);
* tiered: UNEVEN (seed -23, side 5000, ncside 100, N=1e6, the reference
  report's clustered workload) against the JAX package's result, each of
  its 12 classes through both dense kernels (checked, timed, with the
  bound), then 10 steps against the dense engine on the card, whose own
  UNEVEN tiles go through both kernels too.

Then the sweep engine (its four kernels of ``csrc/sweep.cu``: the COM,
the forces, the collision pass, and the occupancy they read on the card;
``ops/cuda/sweep``) and the CLI; each sweep path must launch all four
kernels:

a. ``python -m particlesimulation_tpu_torch`` on golden s1 with the default
   engine (f64 parity) and device (cuda), as a subprocess: the golden lines
   exactly, and "%.1fs" on stderr; then the same in-process, the kernels'
   launches counted;
b. golden s0 and the five small golden vectors through the parity engine
   on cuda at the harness's ±0.001, the counts exact;
c. the parity engine on cuda (the kernels) and on cpu (their plain
   versions), bitwise equal in every field: the kernels' gate on the
   parity engine;
d. the f32 sweep on golden s1 (±0.002, 4 collisions), and 1200 particles
   in one cell through resident, where the ladder must end on the sweep;
e. MEDIUM (golden s3's config, kcap ~2750) through the census: the ladder
   ends on the sweep, overflow 0, and two runs give the same bits;
f. the CLI's fast route in-process, which must launch the fused kernel;
g. the step times of parity s1, the f32 sweep s1 and MEDIUM, with device
   ms, idle share, launches and syncs a step (0: the sweep's run replays
   one CUDA graph and reads nothing back inside it).

Then the sweep's kernels alone (``python3 chip_smoke.py --sweep`` runs
phases a-g, az and ba alone):

az. each kernel against its plain version on the card (``sweep_*_ref``):
   on the sorted states of parity s1, the f32 sweep at s1 and MEDIUM in f32
   and f64, each also after one step, and on
   ``adversarial.sweep_particles`` (a zero-mass lane opening a cell, a
   massless lane inside a massive cell, a coincident pair, two live
   particles out of the box at one position, a collision chain A-B, B-C,
   one hot cell; "wide": a 2600-lane cell with coincident pairs across
   tile boundaries, a first partner that is not the nearest in x, pairs
   at the x window's edge, a live lane at x < 0; "huge": a 10 000-lane
   cell, more than the collision kernel stages at once), sorted and in the
   mesh's layout (``adversarial.mesh_lane_order``: cells contiguous but
   out of key order, sentinel lanes between them; "huge" sorted only), in
   both precisions: parity bit for
   bit; the collision count and the dead set exact; f32 forces bit for bit
   too, f32 COM the sums in position order bit for bit (its kernel's
   order, and its parent's) and within its tolerance of the plain version;
   a second run bit for bit. The COM also on ``adversarial.com_particles``
   (cells opening with massless runs; cells of a round of the kernel's
   staging and a round plus one; masses from 2^-1074 to 2^1023, on both
   sides of the parity division's range edges; 7680 one-lane cells between
   empty ones) in both precisions and layouts, and its parity division
   against ``__ddiv_rn`` on 1.32e7 operand pairs made on the card (random,
   all-ones divisors, quotients next to a rounding midpoint, operands at
   the range's edges, quotients at its ends, numerators +0 and -0): 0
   mismatches. Each kernel
   timed (ms, device ms) at parity s1, the f32 sweep at s1 and MEDIUM in
   f32 and f64 against its bound and its plain version; the fast COM
   beside ``index_add_`` of (m, m·x, m·y) onto the cells; the COM against
   its chain floor too (the longest cell's lanes times one lane's latency
   on its chain, timed by a one-thread kernel running the same chain code:
   ``sweep.com_chain``). On every one of these inputs the occupancy kernel
   against its plain version (``sweep_occupancy_ref``: an ``index_add_`` of
   ones and the maxima), field for field: each key's count (the sentinel
   lanes', wherever they lie, last), kmax, the cells of more than 512
   lanes; timed beside ``index_add_`` + ``amax``;
ba. the reference's heavy golden vectors through the default CLI (parity on
   cuda), a process each, their lines exactly: ``1 5000 100 1000000 100``
   (163), ``1 5000 20 1000000 10`` (MEDIUM in f64, 19), ``3 5000 50 1000000
   300`` (BIG, 469), ``-11 3500 20 500000 10`` (35), ``-50 10000 200 500000
   10`` (4).

``python3 chip_smoke.py --sweep-com`` runs az's COM parts alone (the
division check, the COM case, the kernel against its plain version on
every az input, timed against its bounds and chain floor).
``python3 chip_smoke.py --golden-long`` runs the four long-horizon golden
vectors (``1 1000 3 10000 10000``, ``12 100 5 10000 10000``, ``3 5000 50
1000000 500``, ``-1 1000 30 100000 1000``) through the CLI and prints each
result beside its golden lines, whatever they are.
``python3 chip_smoke.py --sweep-times ROOT [ROOT ...]`` (bb) times parity
s1, the f32 sweep at s1, MEDIUM by the default census, MEDIUM in parity
(golden s3's, the CLI's default) and ``1 1000 3 10000`` in parity (a
long golden vector's: nine cells of ~1100 lanes) with the port
package of each checkout ROOT in turn (a process each; parent, change,
change, parent): ms/step, device ms/step, idle share, launches and syncs a
step (0 required of this checkout), and the digest of each run's final
state after 4 steps, which must agree in all runs.

Then the supercell engine at SMALL (seed 50, side 10000, ncside 1300,
N=5e5, 10 steps; the reference report's sparse workload, not cut):

h. the labelled pass (the warp kernel at K <= 64, the block kernel above)
   on SMALL's own pair-pass tiles and on the adversarial tiles at K = 32,
   64, 160, 288 and 1024 (the 1024 launch opts in to more shared memory)
   under each layout of ``adversarial.label_layouts``, v4 and v2, collide
   on and off: random labels, runs of three between -1s, and labels that
   return later in the row (a grouping that lost slot order within a run
   would sum in another order) against the plain version; every label
   distinct (no pair may collide: count 0, every ft INF, no force); every
   label 0 (the unlabelled kernel's bits); the v4 and v2 forms against an
   f64 truth on SMALL's tiles (the v4 centre is the whole row's mean);
i. the cell sums kernel on SMALL's tiles: within rtol 1e-6 of the plain
   version on the card (atomics in any order), bit for bit equal to the
   plain version on the CPU (slot order) and to itself in a second run;
   the same two bitwise checks on the adversarial tiles of (h), a cell for
   each label and row; its zeroing of the output and its kernel timed
   apart;
j. SMALL through the census (supercell, S = 10), against the JAX package's
   f32 result and the port's f32 sweep on the card; both new kernels must
   launch; no host sync in the run loop; cuda == cpu on an uneven
   partition (7 5.0 25 400, S = 3 over 25 cells);
k. the CLI's fast route at SMALL in-process (the labelled kernel launched);
l. SMALL's step time, device time, idle share, launches and syncs a step.

Then the banded engine (row bands of cells, each band with its own K, in one
slot pool):

m. UNEVEN through the default census: banded on its 13-band plan
   (``launch_sweep.UNEVEN_BANDS``); after 2 steps the JAX f32 engine's 14
   collisions and particle 0; the fused kernel launched;
n. 10 steps of banded against 10 of dense on the card;
o. no host sync in a banded run; cuda == cpu on (-7 100 12 4000) with
   four bands of K 64 to 256 (the v4 form) and on (5 8 8 600) with four
   2-row bands (the v2 form);
p. the fused kernel on the banded run's own tiles of the K = 896 and K = 32
   bands (checked, timed, with the bound), and the lanes each band's pair
   pass needs (Σc² over rows·K²) against one tier at K = 864;
q. UNEVEN banded, tiered and dense timed one after another: step time,
   device time, idle share, launches and syncs a step;
r. N = 1e7 (seed 1, side 5000, ncside 316): the census's streaming route
   (banded on 12 bands of 27 rows, K 192), 10 steps against 10 of
   resident, and both timed.

Then the 1D row mesh (``parallel/sharded.ShardedEngine``) on a local mesh
of the card (D shards in one process), at the flagship (golden s1's config):

s. the CLI with ``--mesh 4`` and ``--mesh 3`` (an uneven split of the 100
   rows), as a subprocess: golden s1's lines exactly;
t. parity (the f64 slab sweep) at D = 4 against the one-device parity
   engine on the card, bit for bit by pid after 4 steps; parity mesh on
   cuda against parity mesh on cpu, bit for bit, on two small configs;
u. fast (resident tiles with halo rows, by the census) at D = 4: golden
   s1's count and particle 0 within ±0.002, the one-device resident run's
   count and dead set, positions within 1e-6·side; the fused kernel
   launched, and held to its plain version on the mesh run's own tiles;
   no host sync in the run loop;
v. the ladder: a slab capacity below the fullest shard's count takes the
   CAP_OVF retry and ends on the bits of the default capacity's run;
w. checkpoints: 2 steps, save, restore as saved (D = 4) and re-packed onto
   D = 2, 2 more steps: parity bit for bit with 4 uninterrupted steps,
   fast with their count and dead set;
x. ms/step, device ms/step, idle share, launches and syncs a step at
   D = 1, 2 and 4 in both precisions.

Then the mesh census's other routes, on local meshes of the card:

y. SMALL at D = 4 through the census: super-cell tiles (S = 10, 130
   super-rows as 33/33/32/32); the JAX f32 result (±0.002) and the
   one-device supercell run's count and dead set, positions within
   1e-6·side; the CLI's ``--mesh 4 --engine fast`` in-process; the
   labelled kernel and the cell sums kernel on the mesh run's own tiles
   and cells; no host sync;
z. UNEVEN at D = 4 through the census: column-sharded bands on the
   one-device plan (13 bands, 25 columns a shard); after 2 steps the JAX
   f32 engine's 14 collisions and particle 0 (±0.002), after 10 the
   one-device banded run's count and dead set (positions within
   2e-5·side), and its particle 0 (±0.002) and count through the CLI's
   ``--mesh 4 --engine fast`` in-process; the fused kernel on the widest
   band's own tiles; no host sync;
aa. the streaming route at the 2e7 point (1 5000 447, D = 2): the
   census's byte figure and band plan, 5 steps against resident tiles on
   the same mesh (count and dead set exact, positions within 1e-6·side);
ab. cuda = cpu on two small configs of each route;
ac. the ladders: SMALL D = 4 from kcap 32, UNEVEN D = 4 from a plan at
   0.7 of each band's K; each grows and ends on the untight run's count
   and dead set (the rung it ended on printed);
ad. ms/step, device ms/step, idle share, launches and syncs a step of
   SMALL and UNEVEN at D = 1, 2 and 4 and on one device.

Then the 2D rectangle mesh (``parallel/sharded2d.Sharded2DEngine``, shard
(r, c) owning a rectangle of cells) and the block-cyclic bands
(``ShardedEngine(impl="banded-cyclic")``), on local meshes of the card:

ae. the CLI with ``--mesh 2x2``: golden s1's lines exactly in parity (as a
   subprocess), and within ±0.002 and the count in fast precision
   (in-process; the fused kernel launched);
af. parity at (2, 2) against the one-device parity engine on the card, bit
   for bit by pid after 4 steps; cuda against cpu bit for bit on (17 0.12 5
   120) at (2, 3), uneven on both axes, and (1 100 8 10000) at (2, 2);
ag. fast at (2, 2) through the census (rectangle tiles with a halo ring):
   golden s1's count and particle 0 (±0.002), the one-device resident
   run's count and dead set with positions within 1e-6·side; the fused
   kernel launched, and held to its plain version on the 2D run's own
   tiles (timed, with the bound); no host sync;
ah. the census under (2, 2): SMALL delegates to super-cells on the 1D mesh
   of 4 shards (the labelled and cell sums kernels launched; the 1D D = 4
   route's bits), UNEVEN to column bands;
ai. UNEVEN at D = 4 on block-cyclic bands (the cyclic plan printed): after
   2 steps the JAX f32 engine's 14 collisions and particle 0 (±0.002),
   after 10 the one-device banded run's count and dead set (positions
   within 2e-5·side); the fused kernel on the widest band's own tiles; no
   host sync;
aj. the ladders: rectangle tiles from kcap 32, a slab 1000 below the
   fullest shard (CAP_OVF), cyclic bands from a plan at 0.7 of each band's
   K; each ends on the untight run's count and dead set;
ak. ms/step, device ms/step, idle share, launches and syncs a step of the
   flagship's fast mesh at (2, 2), (4, 1) and (1, 4) against 1D D = 4,
   parity at (2, 2), and UNEVEN cyclic against column bands at D = 4.

Then the direct model (``models/direct_nbody``: exact all-pairs gravity
and a global EPSILON first-pair search, two CUDA kernels of
``csrc/direct_nbody.cu``):

al. both kernels against their plain versions at N = 1, 4096, 5000 and
   8191 (side 100) and 8191 at side 1 (dense: many hits and chains), in
   float32 and float64, on the planted cases of
   ``ops/cuda/adversarial.plant_direct_cases`` (a pair, a chain of three,
   a coincident pair, a pair across the periodic edge, a dead particle
   within EPSILON of an alive one, a pair at the tail): forces within the
   stated tolerance, the first partners (so the deaths and the count)
   exact;
am. N = 1e5 (seed -1, side 1000: the reference's golden vector -1 1000 30
   100000 1000) with pairs planted past slot 46 340, where the JAX
   package's int32 pair rank would wrap: one step's kernels against the
   plain versions on the card, the partners exact, the planted slots dead;
   the force check shown to reject forces that lack the last tile's 672
   partners (the kernel's tiles are 1024 wide); each kernel's ms, device
   ms and bound, its plain version's ms at N = 1e5 and 8191, and, where the
   toolkit has ``cuobjdump``, its inner loop's SASS instructions a pair;
an. ``DirectSimulation`` at N = 2048 (seed 1, 10 steps, side 100 and side
   1), cuda against cpu: the count and dead set exact, positions within
   DIRECT_TOL·side; two card runs bit for bit equal; the JAX package's
   recorded results (DIRECT_2048, DIRECT_2048_DENSE) held;
ao. no host synchronisation in ``DirectSimulation.advance`` (the run
   loop), and exactly one (the count's readback) in ``run``;
ap. N = 1e5 for 10 steps after a warm-up run (both kernels launched every
   step), timed with ``utils/profiling.bench_fn``: ms/step, pair
   evaluations/s, device ms, idle share and launches a step; both kernels'
   device ms (CUDA events) on the run's own state, in float32 and float64;
aq. the minimum image's threshold: two particles whose displacement is
   exactly the threshold T (``min_image_threshold``), its float
   neighbours, side/2 or one of the floats below side, on either axis, in
   float32 and float64, positions in the box and out of it (|d| >= side
   takes JAX's division): with one partner the force on each is a single
   term, so the kernel's forces equal the plain version's bit for bit; the
   same cases, and pairs near EPSILON across the periodic edge and near the
   collision window's edges, give the plain version's partners.

Then the tile step's kernels around its pair pass (``ops/cuda/advance``,
``csrc/advance.cu``: the monopole terms with the integrator, the one-pass
delivery, the pair pass's masks, and after the pair pass the step's tail
with the next step's sums; the monopole pass, the delivery and the settle
pass write the tiles in place, so every call of a check or a timing gets
its own copy of its input tiles and counters, made outside the timed
window), right after the pair kernels' checks and before the resident
path runs on them:

ar. ``deliver`` against the plain version on the card, every field of
   every slot (holes and their stale values included) and the undelivered
   count bit for bit, and against itself in a second run (with movers
   undelivered, the tiles passed must come back unchanged): on the flagship
   run's own post-integrate tiles (the movers a step printed), on a subset
   of 20 000 of them through ``at=``, on UNEVEN's banded pool (13 bands,
   rows of 13 widths), and on ``adversarial.deliver_cases`` at K = 32, 160
   and 1024 (hops of up to 2 cells and across the box edge, limbo slots; a
   row receiving more than 32 and more than K/2 movers; two full rows
   swapping particles, each arrival in a slot vacated in the same step; a
   full row with 2 movers bound for it: nothing moves, 2 undelivered; three
   full rows handing movers on in a cycle), and at K = 33 (rows off 4-byte
   alignment: the passes' byte-wise reads);
as. ``pair_masks`` and ``settle_sums`` against their plain versions on the
   card: the masks (mf, alive) bit for bit, also through views that start
   one slot in (off 16-byte alignment: the kernel's one-slot path); the
   settle pass after a run's first pass (no deaths, no counters but the
   panics), after a step and after a run's last step (no sums, no limbo):
   m and every counter bit for bit, the sums bit for bit against the plain
   torch sums in the kernel's order (a warp's lanes, then the butterfly:
   ``_lane_order_sums``) and within (K·2⁻²⁴)·Σ|terms| of ``torch.sum``,
   and a second run bit for bit; on the flagship's own tiles after a
   step's delivery and pair pass, UNEVEN's pool (rows of 13 widths), and
   ``adversarial.settle_case`` (deaths planted among holes, dead and limbo
   slots) at K = 32, 33 (rows off 4-byte alignment), 160 and 1024;
at. ``monopole_integrate`` against the plain composition on the card,
   from the settle pass's sums, every output bit for bit: the flagship's
   tiles, UNEVEN's pool, and ``adversarial.advance_case`` (edge cells and
   their mirror offsets, a d² = 0 term, frozen m = 0 slots, positions one
   ulp below side and just below 0 at rest, an empty cell) and
   ``adversarial.wrap_case`` (particles at rest under no force, whose
   x + side is 2·side less an ulp, 2·side, 2·side plus an ulp, side, +0,
   an ulp below 0, below -side); each kernel timed on the flagship's tiles
   against its bound, the settle pass beside three ``torch.sum`` calls;
   golden s1 through resident and UNEVEN through banded must launch all
   four wrappers' kernels, the advance phase (monopole, delivery) of each
   must issue at most 10 kernel launches a step (torch.profiler over 5
   calls of the phase, caught where the engine hands it to
   ``make_tile_run``), and the whole step at most 12 launches a step on
   the resident path (the profile's count equal to the wrappers' counts)
   and 30 on the banded one, with no host synchronisation;
au. ``python3 chip_smoke.py --advance-times ROOT [ROOT ...]``: for each
   checkout in turn (a process each; parent, change, change, parent), the
   flagship resident path, UNEVEN banded and N = 1e7 resident and banded:
   the whole step's ms/step, device ms/step, idle share and launches a
   step, and the digest of each path's final state after 10 steps, which
   must agree in all runs; then each checkout's advance phase (its launches
   and device ms, each wrapper's kernels apart) by its own measure, not
   set side by side (the parent's sums are in its advance phase, the
   change's in its settle pass); where the checkout has the kernels, their
   times on the flagship's tiles against their bounds. Every checkout is
   timed by this checkout's measures
   (``ops/cuda/launch_sweep.device_ms``).

Then tiles wider than 1024 slots (the JAX package's XLA kernels run
them up to MAX_XLA_KCAP = 4096; its Pallas kernels stop at 1024), which
the port's kernels take up to 4096, opting in to the shared memory a row
needs:

av. at K = 1056, 2048 and 4096 on the adversarial tiles, the fused kernel
   in v4, v2 and v1, collide on and off, both dense kernels (with and
   without pids), the labelled block form under every label layout and
   the cell sums on the same tiles, each against its plain version as in
   (h), (i) and the kernel checks above; then at K = 4096 on 132 rows of
   flagship-like tiles (~3000 slots full; 100 labels a row for the
   labelled form and the cell sums) the fused kernel (v4 and v1), the
   labelled form, the cell sums and both dense kernels checked and timed
   against their bounds;
aw. the kernels around the pair pass on rows of K = 4096, bit for bit as
   in (ar)-(at): the delivery on ``adversarial.deliver_cases``, the
   monopole pass on ``advance_case`` and ``wrap_case``, the masks and the
   settle pass on ``settle_case``;
ax. MEDIUM (golden s3's config) with ``Engine(..., dense_backend="xla")``:
   resident tiles at kcap > 1024, overflow 0, the fused kernel and the
   four kernels around it launched, two runs bit for bit equal, no host
   sync; particle 0 and the count printed beside golden s3's f64 values
   and the f32 sweep's of (e) (not held); ms/step, device ms/step, idle
   share, launches and syncs a step; the fused kernel on the run's own
   tiles and both dense kernels on the dense engine's MEDIUM tiles,
   checked, timed, with their bounds; cuda == cpu on the CPU tests'
   ncside-2 config (1 10 2 5000, resident at K = 1440);
ay. MEDIUM through the CLI's ``--mesh 4 --engine fast`` in-process: a tile
   route (the fused kernel launched), its lines printed; the mesh engine
   the CLI builds (resident tiles at kcap > 1024) timed as in (x).

Then the runs as CUDA graphs (``ops/graphed``: a run's steady step, and
with the settle pass its last step, captured once an engine build and
replayed each step) and the COM kernel over many launches:

bc. for each of ``GRAPH_PATHS`` (the flagship resident, N = 1e7 resident
   and banded, UNEVEN banded, MEDIUM on resident tiles, SMALL supercell,
   the mesh's fast, supercell, column-band and cyclic routes at D = 4 and
   the 2D (2, 2) mesh; then the sweep at parity s1, f32 s1, MEDIUM f32,
   MEDIUM in parity (golden s3's config), ``1 1000 3 10000`` in parity
   (teams off; MEDIUM's are on), the parity mesh at D = 2 and 4 and (2,
   2), dense at the flagship and tiered at UNEVEN, and the 1D mesh on
   phase be's NCCL ``DistMesh`` of world size 1, fast and parity; the
   sweep paths' four kernels must have launched, replays counted): the
   graphed run (``run``)
   against the eager one (``run_eager``) from one state, every field and
   counter bit for bit;
   the same engine on a second state (the first run's result) against its
   eager run, its graphs reused (the same graph objects), and the first
   result unchanged after it; on the tile paths and dense a retry forced
   by small tiles (half the census kcap, 0.7 of the band widths, or where
   the engine's floor keeps the kcap 96 particles moved into one cell),
   graphed against eager on two engines built alike; three replays of every captured step under
   ``torch.cuda.set_sync_debug_mode("error")``; the profile's kernels a
   step (a run of k steps less a run of 1: the steady steps) equal,
   graphed and eager; ms/step, device ms/step and idle share of both in
   the same call, the capture's host time and the graphs' pool bytes;
   then a step that reads a value back, whose capture must raise out of
   ``StepGraph`` (no eager fallback), the card running on after it;
bd. ``sweep.sweep_com`` launched back to back in one process: cells of 1
   to 5000 lanes (rounds of 32 to 1024 lanes and past them), cells of mixed
   sizes, ``adversarial.com_particles`` and golden s1's lanes, in f64 and
   f32, sorted and in the mesh's layout, three passes in a seeded order,
   each launch bit for bit against the plain version in parity and the
   position-order sums in f32;
be. the ``torch.distributed`` mesh (``parallel/mesh.DistMesh``, one shard
   a rank) under the 1D row mesh, at golden s1 fast (the census: resident
   tiles, the fused kernel) and in parity (the sweep's kernels): (i) NCCL
   at world size 1 on the card, initialised in this process through a
   ``file://`` store: the run graphed (the steps' all-reduces captured)
   against eager bit for bit, three sync-free replays, golden s1's lines
   (parity's exactly), the final state's digest against ``LocalMesh(1)``'s,
   ms/step; (ii) gloo ranks sharing the card at D = 2 and 4, spawned, each
   running ``run_eager`` (its collectives pass through host memory, so
   ``run`` must refuse): every rank's digest of the gathered state and its
   count against the ``LocalMesh`` engine's at the same D on the card,
   ms/step by rank (host-staged gloo collectives on one card: not a scaling
   number); (iii) NCCL across cards at D = 2, graphed, only where the
   machine has two cards (else printed as not run).

bf. the migration pack (``ops/cuda/migrate``: ``compact``, the emigrant
   buffer, and ``pack``, the landing) and the mesh monopole + integrate
   (``ops/cuda/advance``'s ``tile_monopole_integrate`` and
   ``gathered_monopole_integrate``, the resident and band meshes' rows, a
   thread a slot; ``supercell_monopole_integrate``,
   the super-cell routes' pass from the cell sums, its neighbourhood staged
   where it fits, else every slot building its terms from the sums)
   against their plain
   versions on the card, bit for bit: on ``ops/cuda/adversarial``'s
   ``pack_cases`` (no free slot, overflow, no arrival, all arriving, thin
   arrivals over many blocks with only the last slot free, a buffer of 1,
   f32 fields, the 2D column buffer), ``compact_cases``,
   ``mesh_monopole_case`` (both forms; a row's index, a band pool's rows;
   d² = 0 and subnormal d²; frozen, unbinned and wrapping slots),
   ``row_monopole_cases`` (bands of K 32 to 896, one live slot in 896, 40
   runs) and ``supercell_monopole_cases`` (nc 1-3, short edge
   super-cells, limbo, strays, empty and full rows, a row of 4096, a box
   past the stage, a mesh's tail and halo rows; int64 and int32 cells),
   then on every migration call of the first step of the parity meshes at
   golden s1 (D = 2, 4, (2, 2)) and the monopole + integrate call of the
   six tile engines (the flagship's mesh at D = 4 and (2, 2), SMALL's mesh
   super-cells, UNEVEN's column and cyclic bands at D = 4, SMALL on one
   device) and the ``DistMesh`` NCCL D = 1 super-cell and band paths,
   their own inputs recorded from an eager step; those calls timed against
   their bounds, the super-cells' beside the tables kernel on the same
   sums (run in the main run after ar-at; alone with ``--mesh-kernels``;
   ``--mesh-times`` times the parent's kernels on the same paths, each
   checkout in its own process).

``python3 chip_smoke.py --graphs`` runs phase bc alone,
``python3 chip_smoke.py --com-back-to-back`` phase bd alone,
``python3 chip_smoke.py --dist`` phase be alone.
``python3 chip_smoke.py --wide`` runs phases av-ay alone (MEDIUM's f32
sweep is not run there, so its result is not printed beside the tiles').
``python3 chip_smoke.py --advance`` runs phases ar-at alone, with golden
s1 through resident and UNEVEN through banded (launches, no host sync,
the advance phase's launches, the whole step's launches and syncs, cuda ==
cpu on a small config of each);
``python3 chip_smoke.py --settle-sweep`` times the settle pass at 1 to 16
rows a block (``settle_sweep``), the table its wrapper's constant comes
from;
``python3 chip_smoke.py --supercell`` runs phases h-l alone;
``python3 chip_smoke.py --supercell-times ROOT [ROOT ...]`` runs the
supercell engine's two kernels with the port package of each checkout ROOT
in turn (a process each; parent, change, change, parent): their output
digests on SMALL's tiles and on the adversarial labelled tiles at K = 32,
64, 160 and 1024 under every label layout, which must agree in all runs,
their ms and device ms against the bounds, the all-label-0 tiles' device
ms at K = 32, 64 and 1024, and SMALL's ms/step and device ms/step;
``python3 chip_smoke.py --mesh2d`` runs phases ae-ak alone;
``python3 chip_smoke.py --direct`` runs phases al-aq alone;
``python3 chip_smoke.py --direct-times ROOT [ROOT ...]`` times only the
direct model at N = 1e5 (both kernels' device ms and ms/step), once for
the port package of each checkout ROOT in turn, as ``--mesh-times`` does.
``python3 chip_smoke.py --mesh-times ROOT [ROOT ...]`` times only the
flagship's fast mesh at D = 1, 2 and 4, the parity meshes at D = 2, 4 and
(2, 2), UNEVEN's column and cyclic bands at D = 4, SMALL's mesh
super-cells at D = 4 and SMALL on one device, once for the port package
of each checkout ROOT in turn (a process each): the way to compare two
commits in one call (parent, change, change, parent); each run's final
state after 10 steps must have the same digest in all.

Each path runs with the kernel launch counts set to 0 just before and read
just after, and fails if a kernel of the path did not launch (the mesh
monopole + integrate on every tile mesh and on SMALL, the migration pack
on every parity mesh: its emigrant buffer always, its landing where a
ring hop or the 2D mesh's landing runs). Two steps of
each tile engine's run loop run under
``torch.cuda.set_sync_debug_mode("error")``; each engine on the GPU is
compared with the same engine on the CPU; the flagship, UNEVEN and sweep
steps are timed and their device time broken down by kernel
(torch.profiler), with the kernel launches and host synchronisations a
step. Any failure raises (non-zero exit). The last two lines of standard
output are one JSON object with a record per kernel and one JSON object
naming the device.

Kernel times: CUDA events around each call, median of 20. ``ms`` (the
record's time) times each call alone on an idle card, the wrapper's host
work before the launch included; ``device_ms`` queues the calls behind a
spin kernel, so that the events bracket the kernels alone. The launch
shapes the wrappers' rules pick come from ``ops/cuda/launch_sweep.py``.

Tolerances:
  * collision outputs (ft, count, collisions, dead set) are exact;
  * the sweep kernels: parity (float64) bit for bit their plain versions
    (the same operations in each lane's order, no FMA, IEEE division and
    square root); in float32 the forces bit for bit too (``rsqrtf`` is
    the instruction torch.rsqrt runs: any difference fails); the
    fast COM within c·2⁻²⁴·M + 2⁻²⁴·M for M and (2c + 2)·2⁻²⁴·Σm|x|/M +
    2⁻²⁴·|MX| for the quotients (each cell's c terms summed in position
    order, the plain version's torch.sum in another);
  * kernel forces hold to the plain version within 1e-5·|f| + 1e-6·max|f|
    plus (K + 8)·2^-24 of the summed magnitudes of the terms of each force:
    the worst-case rounding of a (K + 8)-term sequential f32 sum (the
    kernels sum partners one by one, the plain versions pairwise), with a
    few ulps for each term (rsqrtf differs from torch.rsqrt by an ulp or
    so). The terms matter where they cancel: on near pairs, and in the v4
    form always;
  * the v1 kernel equals the gated kernel in the v2 form bit for bit: the
    same arithmetic in the same order;
  * golden s1: particle 0 within ±0.002 of (3936.506, 131.472) (the JAX f32
    engine on a CPU lands 0.0008 from the golden y; the GPU sums in another
    order); UNEVEN after 2 steps: within ±0.002 of the JAX f32 engine's
    (2748.5098, 2624.1592) on a CPU;
  * tiered vs dense on the card: positions within 2e-5·side (f32 reduction
    trees of another shape, tests/test_tiered.py's tolerance);
  * GPU vs CPU runs: positions within 1e-6·side, velocities within
    1e-5·max|v|; the parity engine bit for bit;
  * parity golden vectors: the reference harness's ±0.001 (the CLI's
    three-decimal lines exactly); the f32 sweep on golden s1: ±0.002, as
    the tile engines; MEDIUM's particle 0 against golden s3 is printed,
    not held;
  * the labelled kernel: as the fused kernel, its tolerance's terms summed
    over the pairs of equal labels; all labels 0: bit for bit the
    unlabelled kernel;
  * cell sums: rtol 1e-6 against the plain version on the card (a cell's
    few non-negative terms added in another order), bit for bit against it
    on the CPU;
  * SMALL: the JAX f32 engine's collision count exactly and particle 0
    within ±0.002; against the port's f32 sweep on the card, the count and
    dead set exact and positions within 1e-3 (the JAX package's
    tests/test_supercell.py tolerance);
  * banded UNEVEN: as tiered (the same function); against dense, positions
    within 2e-5·side; at 1e7 against resident, the count and dead set exact
    and positions within 1e-6·side (the same function on the same cell
    rows, another split of the pool).
  * the kernels around the pair pass: the delivery and the monopole pass
    bit for bit their plain versions (the delivery's placement decides the
    fused kernel's summation order; the monopole pass rounds each f32
    operation as eager torch does); the masks, the deaths and the counters
    bit for bit; the settle pass's sums bit for bit the plain sums in its
    own order and within (K·2⁻²⁴)·Σ|terms| of torch.sum (another order of
    the same f32 additions), and bit for bit themselves in a second run;
  * the direct force kernel: per particle and axis within ((K + 16 + P -
    1)·u + (N - 1)·2⁻⁵³)·S of the plain version's own terms summed in
    float64, u the type's unit roundoff (2⁻²⁴ or 2⁻⁵³) and S the sum of
    the terms' magnitudes: the kernel's terms are the plain version's up
    to the rsqrt's ulps (16·u·S), each of its P threads a receiver
    (kForceSplit) adds at most K of them in order, and the P sums are then
    added in order (the worst case of ordered sums, (K + P - 1)·u·S); the
    float64 sum adds at most (N - 1)·2⁻⁵³·S. K is the longest chain a
    thread sums: a part takes 1024/P partners of each tile of 1024
    (kTile), so K = ⌊N/1024⌋·1024/P + min(1024/P, N mod 1024), 25 088 at
    N = 1e5 with P = 4: 1.5e-3·S in float32 (the bound of two sums in any
    order, 2·(N + 8)·u·S, is 1.2e-2·S). Every case prints its largest
    err/tol and the plain version's (its float32 sum against the same
    reference); at N = 1e5 the script also shows that the check rejects
    forces that lack the last tile's partners. With one partner (phase aq)
    the force is one term and both versions' arithmetic is the same, so
    there the forces are equal bit for bit. The direct collision kernel:
    its partners exactly (the minimum image and d² are correctly rounded
    in both versions, and the threshold gives JAX's image bit for bit);

Bounds of the kernels around the pair pass (bytes, each over 3.35 TB/s),
what each function needs: the masks read x, y, m and occ (13 bytes a slot)
and write mf and alive (8); the settle pass reads x, y, m, ft and occ (17
bytes a slot), writes 12 bytes a row and the m of each death (4); the
monopole pass reads x, y, vx, vy, m, fxd, fyd
and occ (29) and writes x, y, vx, vy, dest and moving (21) for a live
slot (m != 0), and reads x, y, m and occ and writes dest and moving (18)
for a frozen one; the delivery reads occ and moving a slot and moves 58
bytes a mover. Beside the last two, ``copy_out_bound_ms``: the floors of
the first designs, which wrote every slot (50 bytes a slot for the monopole
pass; 51 for the delivery's new tiles).

Bounds of phase bf's kernels (bytes): the pack reads the valid and take
flags once and moves each landed entry's fields (read and written) with
its valid flag; the emigrant buffer reads the emig flags and moves every
buffer entry's fields with its valid flag (the plain version fills all of
them); the mesh monopole + integrate reads m, mf, fxd, fyd, x, y, vx, vy
and writes x, y, vx, vy for a live slot (48 bytes), m for a frozen one
(4), the row's index and the binned flag where given, and the 24 table
words of each index read, once; the super-cell pass the same 48 and 4, a
live slot's cell index, the sums (12 bytes a cell) and the halo lines
once, and no table (``library_ms``: none; no single PyTorch call computes
any of these functions).

Phase bg (``check_stencil``; alone: ``--stencil``): the stencil tables'
kernels of ``csrc/stencil.cu`` against their plain versions, bit for bit,
on ``adversarial.stencil_cases`` in f32 and f64, from the COM and from the
sums, and on the tables inputs of an eager step of every route that builds
tables (BG_PATHS); each route's call timed, and its tables phase profiled:
the tables kernel once (on the mesh, once for each 32 bands), and nothing
else but what the plain exchange alone launches (its payload slices and
``mesh.ppermute``'s ``torch.roll``s, profiled on their own). Bounds
(bytes): each grid, line and table entry read or written once;
operations, 16 additions a cell and 16 divisions from the sums, at the
dtype's peak. ``library_ms``: the plain version's gather ``v[:, idx]``
alone, v every source (a 0, the grids, the received lines) and idx each
table entry's (from the plain version's mass table run on the sources'
own indices); the port never calls it. Every path that builds tables must
launch its kernel (``stencil_grid`` on one device, ``stencil_halo`` on the
mesh routes); the super-cell routes (SMALL on one device and on the mesh)
build none: their monopole pass takes the cell sums, and every check of
those paths fails if a stencil kernel launched there.

Bounds of the sweep kernels (``_sweep_bounds``): key (4 bytes) and the
float fields a lane, each output once; 9 operations a lane for the COM, 17
an unordered pair of alive lanes in one cell for the forces (their term
once, added to both ends; the division and square root one operation
each) and 17 a monopole term (8 an alive lane); for the collision test 6
an unordered pair of alive lanes in one cell whose x alone has fl(dx²) <
4·EPSILON² (the x window's candidates, counted on this run's lanes by
``_sweep_candidates``: no other pair can hit), beside the all-pairs figure
(6 every unordered alive pair) as ``all_pairs_bound_ms``; float64
at 34 TFLOP/s, float32 at 67. Beside the COM's, ``chain_floor_ms``: a
cell's lanes are one serial recurrence (the parity mean, and the fast
sums kept in position order), so the COM takes at least its longest
cell's lanes (``plan.kmax``) times one lane's dependent latency on its
chain, timed in this run by a one-thread launch of the kernel's own chain
code (``sweep.com_chain``, 65 536 lanes, CUDA events, median of 5).

Bounds: a kernel's bound is the larger of its bytes over 3.35 TB/s and
its f32 operations over 67 TFLOP/s (H100 SXM data sheet), counted from
this run's tiles. Bytes: each output written once, each input read once
where the function needs it: masses, alive flags and pids of every slot,
x and y only of the slots that take part (used ones, m > 0, for a force,
alive ones for a collision). Operations: 14 per ordered pair of used slots
for the v2 force, 15 for v4, 14 per monopole term (an FMA counts 2, an
rsqrt 1); the labelled kernel's pairs are only those of equal labels (the
function's sum of c² over the cells, which since its redesign is what the
kernel's receivers loop over: each its own label's slots). The cell sums move 16 bytes a slot and 12 a true cell. The collision test's operations are not counted: it need test
only the pairs near in x (a few per alive slot, 6 ops each), which cost
little beside the row's bytes. The rsqrt count is shown against the SFU
rate, 16 per SM and clock: 1/16 of the f32 rate. The direct kernels' bound
also takes that rate in: per pair the force needs 22 f32 operations and one
special-function one (the rsqrt; for |dx| < side the minimum image's
rint(dx / side) is 0 or ±1, ±1 exactly where |dx| reaches one threshold,
so the function needs no division), over the pairs of used particles. The
collision test needs, over each alive particle's alive partners up to its
first hit (or all of them), 2 operations for a pair whose x image alone
has fl(dx²) >= eps2 (dx, one compare: no hit can follow) and 14 and none
on the special-function unit for the rest, the candidates, which the
script counts on this run's data. The larger of the two rates' times
bounds each; float64 counts its operations at 34 TFLOP/s.
"""

import contextlib
import functools
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_S1 = (1, 5000.0, 100, 1_000_000, 4, 3936.506, 131.472, 4)
GOLDEN_TOL = 0.002
# The reference harness's golden vectors (reference serial/run_tests.sh and
# openMP/new_tests.sh) that the parity phases run: s0 and the five small
# ones; and MEDIUM (golden s3's config), whose golden values are printed
# beside the f32 sweep's but not held (f32 over 10 steps at ~2500
# particles a cell has no measured tolerance).
GOLDEN_S0 = (-50, 10000.0, 200, 500_000, 10, 5025.384, 5303.928, 4)
FAST_VECTORS = (
    (1, 2.0, 3, 10, 1, 1.570, 0.056, 0),
    (1, 1.0, 5, 100, 1, 0.786, 0.027, 0),
    (-10, 3.0, 3, 100, 10, 1.733, 1.643, 2),
    (5893, 0.05, 3, 10, 10, 0.002, 0.035, 2),
    (8555, 0.05, 3, 10, 10, 0.016, 0.049, 1),
)
PARITY_TOL = 0.001
MEDIUM = (1, 5000.0, 20, 1_000_000, 10)
GOLDEN_S3 = (3918.912, 143.364, 19)
# Parity on cuda against parity on cpu, bit for bit: several deaths in one
# cell; ~156 particles a cell.
CARD_VS_CPU = ((8555, 0.05, 3, 30, 20), (1, 100.0, 8, 10_000, 10))
# UNEVEN: the reference report's clustered workload; the JAX f32 engine's
# tiered result after 2 steps on a CPU (its plan_tiers plan is
# launch_sweep.UNEVEN_PLAN).
UNEVEN = (-23, 5000.0, 100, 1_000_000)
UNEVEN_2 = (2748.5098, 2624.1592, 14)
# SMALL (BASELINE.md): the JAX f32 sweep's result after 10 steps on a CPU,
# (7907.595703125, 7537.66015625, 1); the JAX supercell engine gives the
# same.
SMALL = (50, 10000.0, 1300, 500_000, 10)
SMALL_10 = (7907.5957, 7537.6602, 1)
SMALL_S = 10
# The direct model: the JAX package's f32 results (seed, side, N, steps,
# particle 0's x and y, count) on a CPU, at side 100 and at side 1 (dense
# enough to collide), and the tolerance (a fraction of side) the port's
# runs are held to (tests/test_torch_direct_model.py holds the constants
# to JAX's live values).
DIRECT_2048 = (1, 100.0, 2048, 10, 71.11087036132812, 7.7793426513671875, 0)
DIRECT_2048_DENSE = (1, 1.0, 2048, 10, 0.7723073959350586,
                     0.03642868995666504, 597)
DIRECT_TOL = 1e-5
# N = 1e5 at the reference's golden vector -1 1000 30 100000 1000 (seed,
# side, N); pairs planted there past slot 46 340 (JAX's int32 pair rank
# i·(n+1)+j wraps from n = 46 341 on); the sizes and sides of phase al.
DIRECT_BIG = (-1, 1000.0, 100_000)
DIRECT_WRAP_PAIRS = ((46_341, 99_999), (60_000, 60_001), (70_000, 46_500))
DIRECT_CASES = ((1, 100.0), (4096, 100.0), (5000, 100.0), (8191, 100.0),
                (8191, 1.0))
# The TPU kernel body each kernel replaces (file:line).
REPLACES = {
    "fused_pairs": "particlesimulation_tpu/ops/pallas/cell_pairs.py:248",
    "fused_pairs_v1": "particlesimulation_tpu/ops/pallas/cell_pairs.py:166",
    "dense_pairwise_forces":
        "particlesimulation_tpu/ops/pallas/cell_pairs.py:45",
    "dense_collisions": "particlesimulation_tpu/ops/pallas/cell_pairs.py:112",
    # XLA code of the JAX package (no Pallas kernel): the `sub` argument of
    # fused_pairs_v2 / _v4, and the supercell per-cell one-hot sums.
    "fused_pairs_sub": "particlesimulation_tpu/ops/dense_xla.py:330",
    "supercell_cell_sums": "particlesimulation_tpu/ops/supercell.py:209",
    # XLA code of the direct model: _pair_forces and make_step's collision
    # block.
    "direct_forces": "particlesimulation_tpu/models/direct_nbody.py:36-80",
    "direct_collisions":
        "particlesimulation_tpu/models/direct_nbody.py:105-117",
    # XLA code of the tile step around its pair pass: monopole_tile_forces
    # (with stencil_tables and integrate), rebin (the port's one-pass
    # deliver), physics_mass (with the pair pass's alive mask, :369), and
    # mono_tables' row sums (with the step's tail, :462-478).
    "monopole_integrate": "particlesimulation_tpu/ops/dense_xla.py:1205",
    "deliver": "particlesimulation_tpu/ops/resident.py:102",
    "pair_masks": "particlesimulation_tpu/engine.py:346-352",
    "settle_sums": "particlesimulation_tpu/engine.py:335-338",
    # XLA code of the sweep engine: com_parity's lax.scan (com_fast :71),
    # the blocked parity force sweep's fori_loop (fast :243, then
    # monopole_forces :289), and the blocked collision sweep.
    "sweep_com": "particlesimulation_tpu/ops/com.py:33",
    "sweep_forces": "particlesimulation_tpu/ops/forces.py:127",
    "sweep_collisions": "particlesimulation_tpu/ops/collisions.py:110",
    # XLA code: the sweep's traced kmax (the JAX step's max_occupancy at
    # engine.py:74 and :103).
    "sweep_occupancy": "particlesimulation_tpu/ops/binning.py:58",
    # XLA code of the mesh engines: the parity mesh's accept (the landing:
    # a stable argsort, a cumsum of the free slots, a gather a field; its
    # emigrant pack :212-221, the 2D mesh's _pack_into :227-244), and the
    # tile meshes' monopole + integrate (sharded_resident.py:345-349; the
    # other meshes' and ops/supercell.py's :209, :404-407 alike).
    "migrate_pack": "particlesimulation_tpu/parallel/sharded.py:223-240",
    "monopole_gathered":
        "particlesimulation_tpu/parallel/sharded_resident.py:345-349",
    # XLA code: the super-cell engines' monopole (ops/supercell.py's
    # monopole_forces_general :209 with integrate :404-407; the mesh's
    # sharded_supercell.py:200-260, :428-431), with the stencil tables it
    # gathers from.
    "monopole_supercell": "particlesimulation_tpu/ops/supercell.py:209",
    # XLA code: the stencil tables (eight rolls and the mirror offsets)
    # with the COM from the sums; the meshes' halo forms with their pads
    # (the 1D mesh's, the 2D mesh's and its two-phase halo :147, the column
    # bands', the cyclic bands' com_tables).
    "stencil_grid": "particlesimulation_tpu/ops/stencil.py:25",
    "stencil_halo": "particlesimulation_tpu/parallel/sharded.py:67 and "
                    ":175-182; sharded2d.py:101, :147-206; "
                    "sharded_banded_cols.py:88; sharded_banded.py:206-265",
}
SOURCE = "particlesimulation_tpu_torch/csrc/cell_pairs.cu"
DIRECT_SOURCE = "particlesimulation_tpu_torch/csrc/direct_nbody.cu"
ADVANCE_SOURCE = "particlesimulation_tpu_torch/csrc/advance.cu"
SWEEP_SOURCE = "particlesimulation_tpu_torch/csrc/sweep.cu"
MIGRATE_SOURCE = "particlesimulation_tpu_torch/csrc/migrate.cu"
# The kernels' names in csrc/, as the profiler reports them.
PORT_KERNELS = ("fused_pairs_kernel", "labelled_warp_kernel",
                "dense_forces_kernel", "dense_collisions_kernel",
                "cell_sums_kernel", "cell_sums_warp_kernel",
                "direct_forces_kernel", "direct_collisions_kernel",
                "monopole_integrate_kernel", "deliver_count_kernel",
                "deliver_stage_kernel", "deliver_place_kernel",
                "deliver_expand_kernel", "pair_masks_kernel",
                "settle_sums_kernel", "sweep_com_kernel",
                "sweep_forces_parity_kernel", "sweep_forces_fast_kernel",
                "sweep_collisions_kernel", "sweep_collision_count_kernel",
                "sweep_occupancy_kernel", "monopole_pool_kernel",
                "monopole_supercell_kernel", "migrate_count_kernel",
                "pack_arrivals_kernel", "pack_place_kernel",
                "compact_place_kernel", "stencil_grid_kernel",
                "stencil_halo_kernel",
                # a parent checkout's (--advance-times) row sums, its
                # sweep force kernel (--sweep-times) and its two mesh
                # monopole kernels (--mesh-times), which these kernels
                # replaced: each named in the per-kernel times
                "cell_sums_rows_kernel", "sweep_forces_kernel",
                "monopole_rows_kernel", "monopole_slots_kernel")
# The kernels of ops/cuda/advance on the resident and banded steps, by
# their launch counts.
ADVANCE_KERNELS = ("monopole_integrate", "deliver", "pair_masks",
                   "settle_sums")
# The sweep engine's kernels (ops/cuda/sweep), by their launch counts.
SWEEP_KERNELS = ("sweep_com", "sweep_forces", "sweep_collisions",
                 "sweep_occupancy")
# The migration pack's two wrappers, by their launch counts (ops/cuda/migrate).
MIGRATE_KERNELS = ("pack", "compact")
# The stencil tables' wrappers (ops/cuda/stencil): one device's, and what a
# mesh route's tables phase launches.
STENCIL_SOURCE = "particlesimulation_tpu_torch/csrc/stencil.cu"
STENCIL_KERNELS = ("stencil_grid", "stencil_halo")
STENCIL_MESH = ("stencil_halo",)
# The super-cell paths' monopole pass, which builds its terms from the cell
# sums: those paths launch no stencil tables kernel.
SC_MONOPOLE = ("monopole_supercell",)
# The bands one stencil_halo launch takes (csrc/stencil.cu kMaxBands).
STENCIL_BANDS = 32

PEAK_BYTES = 3.35e12   # B/s, HBM3
PEAK_F32 = 67e12       # FLOP/s outside the tensor cores
PEAK_SFU = PEAK_F32 / 16
PEAK_F64 = 34e12       # FLOP/s outside the tensor cores


def _timed(fn, reps, fresh=None):
    """Median milliseconds of ``fn`` over ``reps`` calls, each on an idle
    card between CUDA events: the host's work up to the launch included, as
    a caller that waits for each call sees it. With ``fresh``, each call is
    ``fn(fresh())``, the inputs made outside the timed window."""
    sweep = _measures()
    args = sweep.fresh_inputs(fresh, reps + 1)
    sweep.call_with(fn, args[0])
    torch.cuda.synchronize()
    times = []
    for a in args[1:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sweep.call_with(fn, a)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps, fresh=None):
    """``ops/cuda/launch_sweep.device_ms`` of this checkout (see
    ``_measures``)."""
    return _measures().device_ms(fn, reps, fresh)


def _kernel_times(kernel, plain, fresh=None):
    """The record's times: the kernel's per-call and device ms (median of
    20), the plain version's per-call ms (median of 3); with ``fresh``,
    each call on inputs of its own (see ``_timed``)."""
    return {"ms": _timed(kernel, 20, fresh),
            "device_ms": device_ms(kernel, 20, fresh),
            "plain_ms": _timed(plain, 3, fresh)}


def _tiles(ncells, kcap, fill, seed, device):
    """Slot tiles shaped like the flagship's: cells 50 wide on a 100-column
    grid, Poisson(fill) occupied slots with the flagship's mass scale, empty
    slots zeroed, colliding chains planted in every 50th cell, pids permuted
    per row."""
    from particlesimulation_tpu_torch.config import EPSILON, EPSILON2, G

    rng = np.random.default_rng(seed)
    w = 50.0
    cell = np.arange(ncells)
    x = ((cell % 100)[:, None] + rng.uniform(size=(ncells, kcap))) * w
    y = ((cell // 100)[:, None] + rng.uniform(size=(ncells, kcap))) * w
    m = rng.uniform(size=(ncells, kcap)) * 0.01 * 1e4 / 1e6 / G * EPSILON2
    occ = np.arange(kcap)[None, :] < np.minimum(
        rng.poisson(fill, ncells), kcap)[:, None]
    for c in range(0, ncells, 50):
        occ[c, :3] = True
        x[c, 1] = x[c, 0] + EPSILON / 3
        x[c, 2] = x[c, 1] + EPSILON / 3
        y[c, 1:3] = y[c, 0]
    x, y, m = (np.where(occ, a, 0.0).astype(np.float32) for a in (x, y, m))
    pid = np.argsort(rng.uniform(size=(ncells, kcap)), axis=1)
    arrays = (x, y, m, occ.astype(np.int32), pid.astype(np.int32))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _stencil(x, y, m):
    """(ncells, 8) stencil rows from the tiles' COM, on the 100 x 100 grid
    of 50-wide cells that ``_tiles`` lays rows out on."""
    from particlesimulation_tpu_torch.ops import stencil

    n = x.shape[0]
    sums = torch.zeros(3, 10_000, dtype=torch.float32, device=x.device)
    sums[0, :n] = m.sum(1)
    sums[1, :n] = (m * x).sum(1)
    sums[2, :n] = (m * y).sum(1)
    return [t[:n].contiguous()
            for t in stencil.tables_from_sums(*sums, 5000.0, 100)]


def _term_sums(x, y, m_post, form, tables=None, sub=None):
    """Per slot and axis, the summed magnitudes of the force's terms (the
    monopole terms too, given the stencil tables; only the pairs of equal
    labels, given ``sub``)."""
    from particlesimulation_tpu_torch.config import G

    out = []
    # 64 rows a chunk up to K = 1024; fewer above, so that a chunk's (rows,
    # K, K) float64 arrays stay at 512 MB each.
    rows = max(1, min(64, (1 << 26) // (x.shape[1] * x.shape[1])))
    for c0 in range(0, x.shape[0], rows):
        xs, ys, ms = (a[c0:c0 + rows].double() for a in (x, y, m_post))
        if sub is not None:
            ls = sub[c0:c0 + rows]
        if form == "v4":
            used = ms > 0
            n = used.sum(1, keepdim=True).clamp(min=1)
            xs = xs - (xs * used).sum(1, keepdim=True) / n
            ys = ys - (ys * used).sum(1, keepdim=True) / n
        dx = xs[:, None, :] - xs[:, :, None]
        dy = ys[:, None, :] - ys[:, :, None]
        d2 = dx * dx + dy * dy
        inv3 = torch.where(d2 > 0, d2.clamp(min=1e-300) ** -1.5, 0.0)
        w = ms[:, None, :] * inv3 * (G * ms)[:, :, None]
        if sub is not None:
            w = w * (ls[:, None, :] == ls[:, :, None])
        if form == "v4":
            bx = (w * (xs.abs()[:, :, None] + xs.abs()[:, None, :])).sum(2)
            by = (w * (ys.abs()[:, :, None] + ys.abs()[:, None, :])).sum(2)
        else:
            bx = (w * dx.abs()).sum(2)
            by = (w * dy.abs()).sum(2)
        if tables is not None:
            ml, mxl, myl = (t[c0:c0 + rows].double() for t in tables)
            dlx = mxl[:, None, :] - xs[:, :, None]
            dly = myl[:, None, :] - ys[:, :, None]
            d2l = dlx * dlx + dly * dly
            wl = (ml[:, None, :] * torch.where(
                d2l > 0, d2l.clamp(min=1e-300) ** -1.5, 0.0)
                * (G * ms)[:, :, None])
            bx = bx + (wl * dlx.abs()).sum(2)
            by = by + (wl * dly.abs()).sum(2)
        out.append((bx, by))
    return [torch.cat(b) for b in zip(*out)]


def _force_err(got, ref, terms, kcap, tag):
    """Max |kernel - plain| over both axes; raises beyond the tolerance."""
    max_err = 0.0
    for a, b, t in zip(got, ref, terms):
        err = (a.double() - b.double()).abs()
        tol = (1e-5 * b.double().abs() + 1e-6 * float(b.abs().max())
               + (kcap + 8) * 2.0 ** -24 * t)
        if not bool((err <= tol).all()):
            raise AssertionError(f"{tag}: force off by {float(err.max())}")
        max_err = max(max_err, float(err.max()))
    return max_err


def _bound(nbytes, ops, rsqrt):
    """(bound_ms, bound_by, sfu_ms) of a kernel's work."""
    mem_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = ops / PEAK_F32 * 1e3
    return (max(mem_ms, ops_ms), "bytes" if mem_ms >= ops_ms else "operations",
            rsqrt / PEAK_SFU * 1e3)


def _pairs(mask, sub=None):
    """(ordered pairs, unordered pairs) of set slots, summed over rows; only
    the pairs of equal labels, given ``sub`` (labels >= 0 on set slots)."""
    if sub is None:
        n = mask.sum(1).double()
    else:
        nlab = int(sub.max()) + 2
        row = torch.arange(sub.shape[0], device=sub.device)[:, None]
        key = (row * nlab + sub + 1)[mask]
        n = torch.bincount(key).double()
    return float((n * (n - 1)).sum()), float((n * (n - 1) / 2).sum())


def _force_bound(x, m):
    """(bound_ms, bound_by, sfu_ms) of the dense force kernel on tiles: m
    read and fx, fy written for every slot, x and y read for the used
    ones, 96 bytes of stencil rows a cell."""
    p_force, _ = _pairs(m > 0)
    used = float((m > 0).sum())
    return _bound(12 * x.numel() + 8 * used + 96 * x.shape[0],
                  14 * p_force + 8 * 14 * used, p_force + 8 * used)


def _collision_bound(x, alive, with_pid=False):
    """(bound_ms, bound_by, sfu_ms) of the collision kernel on tiles, bytes
    only: alive (and pid) read and ft written for every slot, x and y read
    for the alive ones, the count written."""
    n_alive = float((alive > 0).sum())
    return _bound((12 if with_pid else 8) * x.numel() + 8 * n_alive + 4,
                  0, 0)


def _report(tag, rec):
    print(f"{tag}: max|df|={rec['max_abs_err']:.3e}; kernel "
          f"{rec['ms']:.4f} ms a call ({rec['device_ms']:.4f} ms of device "
          f"time), plain {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), rsqrt at the SFU "
          f"rate {rec['sfu_ms']:.4f} ms", flush=True)


def _check_collisions(got, ref, tag, planted=True):
    if not torch.equal(got[1], ref[1]):
        raise AssertionError(f"{tag}: ft differs in "
                             f"{int((got[1] != ref[1]).sum())} slots")
    if int(got[0]) != int(ref[0]):
        raise AssertionError(f"{tag}: count {int(got[0])} != {int(ref[0])}")
    if planted and int(ref[0]) == 0:
        raise AssertionError(f"{tag}: the planted chains did not collide")


def check_fused(ncells, kcap, fill, form, collide, gated=True):
    """The fused kernel on synthetic flagship-like tiles (``_tiles``)."""
    return fused_record(f"({ncells}, {kcap})",
                        _tiles(ncells, kcap, fill, kcap + ncells, "cuda"),
                        form, collide, gated)


def fused_record(where, tiles, form, collide, gated=True, planted=True,
                 sub=None):
    """Fused pair kernel vs plain version on (x, y, mf, alive, pid) tiles on
    the card (labelled by ``sub``, where given); the measured numbers. The
    ungated (v1) kernel must also equal the gated one bit for bit."""
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    x, y, m, alive, pid = tiles
    kcap = x.shape[1]
    args = (x, y, m, alive, pid, kcap, EPSILON, collide, form)
    kw = {} if sub is None else {"sub": sub}
    got = cell_pairs.fused_pairs(*args, gated=gated, **kw)
    ref = cell_pairs.fused_pairs_ref(*args, **kw)
    torch.cuda.synchronize()
    name = "fused_pairs_sub" if sub is not None else (
        "fused_pairs" if gated else "fused_pairs_v1")
    tag = f"{name} {form} collide={collide} {where}"
    if collide:
        _check_collisions((got[2], got[3]), (ref[2], ref[3]), tag, planted)
    elif not torch.equal(got[3], ref[3]) or int(got[2]) != 0:
        raise AssertionError(f"{tag}: collisions reported with collide off")
    if not gated:
        gated_out = cell_pairs.fused_pairs(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, gated_out)):
            raise AssertionError(f"{tag}: not bitwise equal to the gated "
                                 f"kernel")
    m_post = torch.where(ref[3] != cell_pairs.INF, 0.0, m)
    max_err = _force_err(got[:2], ref[:2],
                         _term_sums(x, y, m_post, form, sub=sub), kcap, tag)
    # mf read and fx, fy, ft written for every slot, alive and pid too with
    # collide on, and the label; x and y read for the alive or used ones.
    p_force, _ = _pairs(m_post > 0, sub)
    n_xy = float((((alive > 0) & collide) | (m > 0)).sum())
    bound_ms, bound_by, sfu_ms = _bound(
        ((24 if collide else 16) + (0 if sub is None else 4)) * x.numel()
        + 8 * n_xy + 4, (15 if form == "v4" else 14) * p_force, p_force)
    rec = {"max_abs_err": max_err,
           **_kernel_times(
               lambda: cell_pairs.fused_pairs(*args, gated=gated, **kw),
               lambda: cell_pairs.fused_pairs_ref(*args, **kw)),
           "bound_ms": bound_ms, "bound_by": bound_by, "sfu_ms": sfu_ms}
    if sub is not None:
        rec["pairs"] = (_pairs(m_post > 0)[0], p_force)
        print(f"{tag}: each receiver loops over its own label's used slots: "
              f"{p_force:.0f} ordered pairs (Σc² a cell) of the rows' "
              f"{rec['pairs'][0]:.0f} (n² a row)", flush=True)
    _report(f"{tag}: ft, count={int(got[2])} exact", rec)
    return rec


def check_dense_forces(ncells, kcap, fill):
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    x, y, m, _, _ = _tiles(ncells, kcap, fill, kcap + ncells + 1, "cuda")
    tables = _stencil(x, y, m)
    args = (x, y, m, *tables, kcap)
    got = cell_pairs.dense_pairwise_forces(*args)
    ref = cell_pairs.dense_pairwise_forces_ref(*args)
    torch.cuda.synchronize()
    tag = f"dense_pairwise_forces ({ncells}, {kcap})"
    max_err = _force_err(got, ref, _term_sums(x, y, m, "v2", tables), kcap,
                         tag)
    bound_ms, bound_by, sfu_ms = _force_bound(x, m)
    rec = {"max_abs_err": max_err,
           **_kernel_times(
               lambda: cell_pairs.dense_pairwise_forces(*args),
               lambda: cell_pairs.dense_pairwise_forces_ref(*args)),
           "bound_ms": bound_ms, "bound_by": bound_by, "sfu_ms": sfu_ms}
    _report(tag, rec)
    return rec


def check_dense_collisions(ncells, kcap, fill, with_pid):
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    x, y, _, alive, pid = _tiles(ncells, kcap, fill, kcap + ncells + 2,
                                 "cuda")
    args = (x, y, alive, kcap, EPSILON, pid if with_pid else None)
    got = cell_pairs.dense_collisions(*args)
    ref = cell_pairs.dense_collisions_ref(*args)
    torch.cuda.synchronize()
    tag = (f"dense_collisions {'pid' if with_pid else 'no pid'} "
           f"({ncells}, {kcap})")
    _check_collisions(got, ref, tag)
    bound_ms, bound_by, sfu_ms = _collision_bound(x, alive, with_pid)
    rec = {"max_abs_err": 0.0,
           **_kernel_times(lambda: cell_pairs.dense_collisions(*args),
                           lambda: cell_pairs.dense_collisions_ref(*args)),
           "bound_ms": bound_ms, "bound_by": bound_by, "sfu_ms": sfu_ms}
    _report(f"{tag}: ft, count={int(got[0])} exact", rec)
    return rec


def check_adversarial(kcap):
    """The adversarial tiles (ops/cuda/adversarial.py: a row whose only
    alive slots are the last two, holes, an empty row, a 48-particle
    cluster, a full row, a vertical line of near pairs, a row whose alive
    slots all collide, a row with one used slot) through the dense kernels
    and the fused kernels, against the plain versions: ft and count exact,
    forces within the tolerance, v1 bitwise equal to the gated kernel."""
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs
    from particlesimulation_tpu_torch.ops.cuda.adversarial import (
        adversarial_tiles)

    x, y, m, alive, pid = (torch.from_numpy(a).cuda()
                           for a in adversarial_tiles(kcap, kcap))
    rng = np.random.default_rng(kcap)
    tables = [torch.from_numpy(rng.uniform(lo, hi, (x.shape[0], 8)).astype(
        np.float32)).cuda() for lo, hi in ((5.0, 50.0), (-1.0, 2.0),
                                           (-1.0, 2.0))]
    tag = f"adversarial K={kcap}"
    counts = []
    for p in (None, pid):
        args = (x, y, alive, kcap, EPSILON, p)
        got = cell_pairs.dense_collisions(*args)
        _check_collisions(got, cell_pairs.dense_collisions_ref(*args),
                          f"{tag} dense_collisions pid={p is not None}")
        counts.append(int(got[0]))
    args = (x, y, m, *tables, kcap)
    err = _force_err(cell_pairs.dense_pairwise_forces(*args),
                     cell_pairs.dense_pairwise_forces_ref(*args),
                     _term_sums(x, y, m, "v2", tables), kcap,
                     f"{tag} dense_pairwise_forces")
    for form in ("v4", "v2"):
        args = (x, y, m, alive, pid, kcap, EPSILON, True, form)
        got = cell_pairs.fused_pairs(*args)
        ref = cell_pairs.fused_pairs_ref(*args)
        _check_collisions((got[2], got[3]), (ref[2], ref[3]),
                          f"{tag} fused_pairs {form}")
        m_post = torch.where(ref[3] != cell_pairs.INF, 0.0, m)
        _force_err(got[:2], ref[:2], _term_sums(x, y, m_post, form), kcap,
                   f"{tag} fused_pairs {form}")
        if form == "v2":
            v1 = cell_pairs.fused_pairs(*args, gated=False)
            if not all(torch.equal(a, b) for a, b in zip(v1, got)):
                raise AssertionError(f"{tag}: v1 not bitwise equal to the "
                                     f"gated kernel")
    torch.cuda.synchronize()
    print(f"{tag}: dense_collisions ft, count={counts[0]} (no pid), "
          f"{counts[1]} (pid) exact; dense_pairwise_forces max|df|="
          f"{err:.3e}; fused v4, v2, v1 exact on ft and count, v1 = gated",
          flush=True)


def check_tiles(label, tile_sets):
    """Both dense kernels on a path's own tiles, one (x, y, m, ml, mxl,
    myl) set per launch of each kernel in a step (one for dense, one per
    class for tiered): each held against the plain versions (forces within
    the tolerance, ft and count exact), timed, with its bound; then the
    sums over the sets, a step's worth."""
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    names = ("dense_pairwise_forces", "dense_collisions")
    sums = {k: [0.0, 0.0, 0.0] for k in names}  # ms a call, device, bound
    for x, y, m, ml, mxl, myl in tile_sets:
        rows, kcap = x.shape
        alive = (m > 0).to(torch.int32)
        fargs = (x, y, m, ml, mxl, myl, kcap)
        cargs = (x, y, alive, kcap, EPSILON)
        tag = f"{label} tiles ({rows}, {kcap})"
        err = _force_err(cell_pairs.dense_pairwise_forces(*fargs),
                         cell_pairs.dense_pairwise_forces_ref(*fargs),
                         _term_sums(x, y, m, "v2", (ml, mxl, myl)), kcap, tag)
        _check_collisions(cell_pairs.dense_collisions(*cargs),
                          cell_pairs.dense_collisions_ref(*cargs), tag,
                          planted=False)
        out = []
        for name, fn, bound in (
                (names[0], lambda: cell_pairs.dense_pairwise_forces(*fargs),
                 _force_bound(x, m)[0]),
                (names[1], lambda: cell_pairs.dense_collisions(*cargs),
                 _collision_bound(x, alive)[0])):
            times = (_timed(fn, 20), device_ms(fn, 20), bound)
            sums[name] = [a + b for a, b in zip(sums[name], times)]
            out.append("{} {:.4f} ms a call, {:.4f} device (bound {:.4f})"
                       .format(name, *times))
        print(f"{tag}, {int(alive.sum(1).max())} alive at most, "
              f"max|df|={err:.2e}, ft and count exact: " + "; ".join(out),
              flush=True)
    print(f"{label}, summed over its {len(tile_sets)} tile set(s): "
          + "; ".join("{} {:.4f} ms a call, {:.4f} device (bound {:.4f})"
                      .format(k, *v) for k, v in sums.items()), flush=True)


def _migrate_launches():
    """``ops/cuda/migrate``'s launch counts (a parent checkout without the
    module, timed by ``--mesh-times``: none)."""
    try:
        from particlesimulation_tpu_torch.ops.cuda import migrate
    except ImportError:
        return None
    return migrate


def reset_launches():
    """Set the launch counts of the tile kernels, the migration pack and
    the stencil tables to 0."""
    from particlesimulation_tpu_torch.ops.cuda import advance, cell_pairs

    cell_pairs.reset_launches()
    advance.reset_launches()
    for mod in (_migrate_launches(), _stencil_module()):
        if mod is not None:
            mod.reset_launches()


def read_launches():
    """The tile kernels', the migration pack's and the stencil tables'
    launch counts, by name."""
    from particlesimulation_tpu_torch.ops.cuda import advance, cell_pairs

    got = {**cell_pairs.LAUNCHES, **advance.LAUNCHES}
    for mod in (_migrate_launches(), _stencil_module()):
        if mod is not None:
            got.update(mod.LAUNCHES)
    return got


def require_launches(label, launches, kernels):
    """Fail unless every kernel of ``kernels`` launched on the path."""
    missing = [k for k in kernels if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{label}: {missing} did not launch: "
                             f"{launches}")


def forbid_launches(label, launches, kernels):
    """Fail if a kernel of ``kernels`` launched on the path (the super-cell
    paths build no stencil tables)."""
    ran = [k for k in kernels if launches.get(k, 0) > 0]
    if ran:
        raise AssertionError(f"{label}: {ran} launched: {launches}")


def drive(label, eng, state, steps, kernels):
    """One run of a path with the launch counts set to 0 just before it and
    read just after; fails if a kernel of the path did not launch."""
    torch.cuda.synchronize()
    reset_launches()
    out = eng.run(state, steps)
    torch.cuda.synchronize()
    launches = read_launches()
    x, y, c = eng.result(out)
    finite = bool(torch.isfinite(out.x).all() and torch.isfinite(out.y).all())
    print(f"{label} on cuda: {eng.impl}, kcap {eng.kcap}, particle 0 "
          f"({x:.4f}, {y:.4f}), collisions {c}, overflow "
          f"{int(out.overflow)}, launches {launches}", flush=True)
    if not (finite and out.x.shape == state.x.shape
            and int(out.overflow) == 0):
        raise AssertionError(f"{label}: non-finite, misshapen or overflowed")
    if not all(launches[k] > 0 for k in kernels):
        raise AssertionError(f"{label}: a kernel of the path did not launch")
    return out, (x, y, c), launches


def check_golden(label, eng, state, steps, golden, kernels):
    """A path's run against known values of particle 0 and the count."""
    ex, ey, ec = golden
    out, (x, y, c), launches = drive(label, eng, state, steps, kernels)
    if not (c == ec and abs(x - ex) <= GOLDEN_TOL and abs(y - ey) <= GOLDEN_TOL):
        raise AssertionError(f"{label}: ({x}, {y}, {c}) vs ({ex}, {ey}, {ec})")
    return out, launches


def check_no_sync(label, run, state):
    """The run loop must not synchronise with the host: any synchronising
    CUDA call inside it raises here."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(state, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"{label} run loop: no host synchronisation in 2 steps", flush=True)


def _by_pid(state):
    order = torch.argsort(state.pid)
    return {f: getattr(state, f)[order].cpu()
            for f in ("x", "y", "vx", "alive")}


def compare_runs(label, a, b, pos_tol, v_tol):
    """Collisions and dead sets exact; positions and velocities within the
    given fractions of side and max|v|."""
    (ca, sa, side), (cb, sb, _) = a, b
    ga, gb = _by_pid(sa), _by_pid(sb)
    if ca != cb or not torch.equal(ga["alive"], gb["alive"]):
        raise AssertionError(f"{label}: collisions {ca} vs {cb}, dead sets "
                             f"equal: {torch.equal(ga['alive'], gb['alive'])}")
    dpos = max(float((ga[f] - gb[f]).abs().max()) for f in ("x", "y"))
    dvx = float((ga["vx"] - gb["vx"]).abs().max())
    vmax = float(gb["vx"].abs().max())
    if dpos > pos_tol * side or (v_tol is not None and dvx > v_tol * vmax):
        raise AssertionError(f"{label}: |dx|={dpos}, |dvx|={dvx}")
    print(f"{label}: collisions {ca} = {cb}, dead sets equal, "
          f"max|dpos|={dpos:.3e}, max|dvx|={dvx:.3e}", flush=True)


def check_gpu_vs_cpu(seed, side, nc, n, steps, impl=None, plan=None,
                     **engine_kw):
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine

    outs = []
    for device in ("cuda", "cpu"):
        eng = Engine(SimConfig(seed, side, nc, n), impl=impl, device=device,
                     **engine_kw)
        state = eng.init_state()
        if plan is not None:
            eng._band_plan = plan
        out = eng.run(state, steps)
        if int(out.overflow) != 0:
            raise AssertionError(f"overflow on {device}")
        if impl is not None and eng.impl != impl:
            raise AssertionError(f"{impl} escalated to {eng.impl}")
        outs.append((int(out.collisions), out, side))
    compare_runs(f"cuda vs cpu, {eng.impl} kcap {eng.kcap} ({seed} {side} "
                 f"{nc} {n}, {steps} steps)", *outs, 1e-6, 1e-5)


def step_ms(eng, state, k, reps=2, run=None):
    """Per-step ms as (t(run k+1) - t(run 1)) / k, best of ``reps``
    (``run``: ``eng.run`` by default)."""
    run = run or eng.run

    def run_seconds(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        o = run(state, steps)
        torch.cuda.synchronize()
        if int(o.overflow) != 0:
            raise AssertionError("overflow in the timed run")
        return time.perf_counter() - t

    t1 = min(run_seconds(1) for _ in range(reps))
    tk = min(run_seconds(k + 1) for _ in range(reps))
    return (tk - t1) / k * 1e3, t1, tk


def _profile(eng, state, steps, run=None):
    """(device ms, kernel launches) of one run of ``steps``, by name:
    [(ms, launches, name)], from torch.profiler. A graphed run's graphs are
    captured anew just before the session (``_recapture``)."""
    run = run or eng.run
    return _profile_fn(lambda: run(state, steps),
                       before=lambda: _recapture(eng, state, run))


def _recapture(eng, state, run):
    """Where ``run`` replays graphs (``eng.run``, or a GraphedRun), drop
    them and capture them again with a run of 0 steps. CUPTI faults inside
    ``cuGraphLaunch`` when a graph captured before other profiler sessions
    and other graphs is replayed under a session (a segfault in libcupti's
    launch callback, PERF.md section 7); a graph captured just before its
    session has not. ``check_long_lived`` replays long-lived graphs
    unprofiled."""
    from particlesimulation_tpu_torch.ops import graphed

    kind = getattr(graphed, "GraphedRun", None)  # None: an older checkout
    if kind is None:
        return
    if isinstance(run, kind):
        runs = run
    elif run == getattr(eng, "run", None) and isinstance(
            getattr(_target(eng), "_run", None), kind):
        runs = _target(eng)._run
    else:
        return
    runs.release()
    run(state, 0)
    torch.cuda.synchronize()


# The pause after each marker kernel of a profiler session, in seconds.
PROFILE_PAUSE_S = 0.02


def _profile_fn(fn, before=None):
    """[(device ms, launches, name)] of one call of ``fn`` (torch.profiler;
    copies and memsets count no launch, nor do the kernels that carry out a
    CUDA graph's copy and memset nodes, ``memcpy32_post`` and the like).
    ``before()`` runs between the two sessions, unprofiled. Inside the
    session a marker kernel (``torch.cuda._sleep``'s ``spin_kernel``, left
    out of the rows) runs and is waited for on each side of ``fn``, with a
    pause: without them the profiler has dropped a session's first kernels
    (a run's prologue) or let another run's land in it, a count a step off
    by a fraction (PERF.md section 7)."""
    from torch.profiler import ProfilerActivity, profile

    def marker():
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAUSE_S)

    torch.cuda.synchronize()
    # A session of nothing first: a kernel record that an earlier session
    # delivers late lands there, not in this one's.
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    if before is not None:
        before()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker()
        fn()
        torch.cuda.synchronize()
        marker()
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0 and "spin_kernel" not in evt.key:
            copy = evt.key.lower().startswith(("memcpy", "memset"))
            rows.append((us / 1e3, 0 if copy else evt.count, evt.key))
    return rows


def _syncs(eng, state, steps, run=None):
    """Host synchronisations (readbacks) in one run of ``steps``: the
    warnings of torch's CUDA sync debug mode, one per synchronising call."""
    run = run or eng.run
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run(state, steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def device_breakdown(label, eng, state, step_ms_host, steps=10, run=None,
                     base=0):
    """Device time per step by kernel name, the share of the unprofiled
    step the device is idle, and per step the kernel launches and host
    synchronisations: each a run of ``steps`` less a run of ``base``
    steps (0: its prologue and epilogue), over ``steps - base``
    (torch.profiler; torch's sync debug mode). Also ``device_ms_whole``: the whole run of ``steps`` over
    ``steps``, its prologue and epilogue included (the older records'
    device ms/step). ``run``: ``eng.run`` by default; ``base``:
    the steps of the run taken off (1 leaves a graphed run's carry load and
    its last step out: the steady steps alone)."""
    rows = _profile(eng, state, steps, run)
    rows0 = _profile(eng, state, base, run)
    n = steps - base
    launches = (sum(k for _, k, _ in rows) - sum(k for _, k, _ in rows0)) / n
    calls0 = {key: k for _, k, key in rows0}
    per_kernel = {key: (k - calls0.get(key, 0)) / n for _, k, key in rows}
    _syncs(eng, state, 0, run)  # the first count holds a one-off sync
    syncs = (_syncs(eng, state, steps, run)
             - _syncs(eng, state, base, run)) / n
    whole = sum(ms for ms, _, _ in rows) / steps
    less = {key: ms for ms, _, key in rows0}
    rows = sorted((((ms - less.get(key, 0.0)) / n, key)
                   for ms, _, key in rows), reverse=True)
    total = sum(ms for ms, _ in rows)
    top = "; ".join(f"{key[:48]} {ms:.4f}" for ms, key in rows[:8])
    ours = {name: sum(ms for ms, key in rows if name in key)
            for name in PORT_KERNELS}
    print(f"{label}: device {total:.4f} ms/step of {step_ms_host:.4f} "
          f"ms/step (the whole run's {whole:.4f}), idle "
          f"{1 - total / step_ms_host:.1%}; {launches:.1f} "
          f"kernel launches and {syncs:.2f} host synchronisations a step; "
          f"by kernel (ms/step): {top}; the port's kernels (ms/step): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ours.items() if v > 0),
          flush=True)
    return {"device_ms": total, "device_ms_whole": whole,
            "idle": 1 - total / step_ms_host, "launches": launches,
            "syncs": syncs, "kernels": {k: v for k, v in ours.items() if v},
            "per_kernel": per_kernel,
            "per_kernel_ms": {key[:60]: ms for ms, key in rows[:12]}}


def steady_breakdown(label, eng, state, step_ms_host, steps):
    """``device_breakdown`` of the steady steps (a run of ``steps`` less a
    run of 1), taken again (up to twice) where the profiler lost or
    misplaced kernel records: a count of launches a step that is not a
    whole number, or more device time than 1.05x the step took."""
    for again in range(3):
        times = device_breakdown(label + (" (again)" if again else ""), eng,
                                 state, step_ms_host, steps, base=1)
        whole = abs(times["launches"] - round(times["launches"])) < 0.01
        if whole and times["idle"] > -0.05:
            break
    return times


def _parity(seed, side, nc, n, device):
    from particlesimulation_tpu_torch.config import Precision, SimConfig
    from particlesimulation_tpu_torch.engine import Engine

    return Engine(SimConfig(seed, side, nc, n, precision=Precision.PARITY),
                  device=device)


def check_cli_parity(extra=()):
    """(a, s, ae) The CLI as a user runs it, with the default engine
    (parity) and device (cuda), and ``extra`` arguments (``--mesh N`` or
    ``RxC``): golden s1's exact output lines, and "%.1fs" on stderr."""
    seed, side, nc, n, steps, ex, ey, ec = GOLDEN_S1
    args = [str(seed), str(int(side)), str(nc), str(n), str(steps), *extra]
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "particlesimulation_tpu_torch",
                        *args], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    lines = r.stdout.splitlines()
    timing = (r.stderr.strip().splitlines() or [""])[-1]
    want = [f"{ex:.3f} {ey:.3f}", str(ec)]
    if r.returncode != 0 or lines != want or not re.fullmatch(
            r"\d+\.\ds", timing):
        raise AssertionError(f"CLI parity {args}: rc {r.returncode}, stdout "
                             f"{lines}, stderr {r.stderr[-2000:]}")
    print(f"CLI parity {' '.join(args)} on cuda: {lines} (the golden "
          f"values), {timing} on stderr, {time.perf_counter() - t:.1f} s "
          f"with the process start", flush=True)


def check_parity_golden():
    """(b) Golden s0 and the five small golden vectors through the parity
    engine on cuda: the reference harness's ±0.001, the count exact; the
    sweep kernels launched."""
    reset_sweep_launches()
    for seed, side, nc, n, steps, ex, ey, ec in (GOLDEN_S0,) + FAST_VECTORS:
        eng = _parity(seed, side, nc, n, "cuda")
        out = eng.run(eng.init_state(), steps)
        x, y, c = eng.result(out)
        print(f"parity golden {seed} {side} {nc} {n} {steps} on cuda: "
              f"({x:.6f}, {y:.6f}), {c} collisions; golden ({ex}, {ey}), "
              f"{ec}", flush=True)
        if not (eng.impl == "sweep" and out.x.dtype == torch.float64
                and c == ec and abs(x - ex) <= PARITY_TOL
                and abs(y - ey) <= PARITY_TOL):
            raise AssertionError(f"parity golden {seed} {side} {nc} {n}")
    read_sweep_launches("parity golden s0 and the small vectors")


def check_parity_card_vs_cpu():
    """(c) The parity engine on cuda and on cpu, field by field with
    torch.equal: the card contracted nothing and took no reciprocal. The
    card runs the sweep kernels, the CPU their plain versions: the kernels'
    gate on the parity engine."""
    reset_sweep_launches()
    for seed, side, nc, n, steps in CARD_VS_CPU:
        outs = []
        for device in ("cuda", "cpu"):
            eng = _parity(seed, side, nc, n, device)
            outs.append(eng.run(eng.init_state(), steps))
        fields = ("x", "y", "vx", "vy", "m", "alive", "pid", "collisions")
        bad = [f for f in fields if not torch.equal(
            getattr(outs[0], f).cpu(), getattr(outs[1], f))]
        if bad:
            raise AssertionError(f"parity cuda vs cpu {seed} {side} {nc} "
                                 f"{n}: {bad} differ")
        print(f"parity cuda vs cpu ({seed} {side} {nc} {n}, {steps} steps): "
              f"{', '.join(fields)} bitwise equal; {int(outs[1].collisions)} "
              f"collisions", flush=True)
    read_sweep_launches("parity cuda vs cpu (the cuda runs)")


def check_f32_sweep():
    """(d) The f32 sweep: golden s1 within ±0.002 and 4 collisions; 1200
    particles in one cell through resident, where the ladder must end on
    the sweep."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine

    seed, side, nc, n, steps, ex, ey, ec = GOLDEN_S1
    eng = Engine(SimConfig(seed, side, nc, n), impl="sweep", device="cuda")
    state = eng.init_state()
    torch.cuda.synchronize()
    reset_sweep_launches()
    out = eng.run(state, steps)
    launches = read_sweep_launches("f32 sweep s1")
    x, y, c = eng.result(out)
    print(f"golden s1 f32 sweep on cuda: ({x:.4f}, {y:.4f}), {c} collisions, "
          f"overflow {int(out.overflow)}, launches {launches}", flush=True)
    if not (eng.impl == "sweep" and c == ec and abs(x - ex) <= GOLDEN_TOL
            and abs(y - ey) <= GOLDEN_TOL and int(out.overflow) == 0):
        raise AssertionError("golden s1 f32 sweep")
    eng = Engine(SimConfig(1, 10.0, 1, 1200), impl="resident", device="cuda")
    state = eng.init_state()
    reset_sweep_launches()
    out = eng.run(state, 2)
    launches = read_sweep_launches("ladder to the sweep (1 10 1 1200)")
    print(f"1200 particles in one cell, from resident: the ladder ends on "
          f"{eng.impl}, overflow {int(out.overflow)}, collisions "
          f"{int(out.collisions)}, sweep launches {launches}", flush=True)
    if eng.impl != "sweep" or int(out.overflow) != 0:
        raise AssertionError("the ladder did not end on the sweep")


def check_medium():
    """(e) MEDIUM through the census: the ladder (resident -> dense ->
    sweep) ends on the sweep with overflow 0, and two runs give the same
    bits. Returns the engine, its initial state, its ms/step and its
    result (particle 0 and the count after MEDIUM's steps)."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine

    seed, side, nc, n, steps = MEDIUM
    eng = Engine(SimConfig(seed, side, nc, n), device="cuda")
    state = eng.init_state()

    def timed_run(k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eng.run(state, k)  # ends in a readback
        return out, time.perf_counter() - t

    reset_sweep_launches()
    first, t_ladder = timed_run(steps)
    launches = read_sweep_launches("MEDIUM (the census's ladder -> sweep)")
    second, t_k = timed_run(steps)
    t_1 = timed_run(1)[1]
    runs = [first, second]
    fields = ("x", "y", "vx", "vy", "m", "alive", "pid", "collisions")
    same = all(torch.equal(getattr(runs[0], f), getattr(runs[1], f))
               for f in fields)
    x, y, c = eng.result(runs[0])
    print(f"MEDIUM {seed} {side} {nc} {n}, {steps} steps on cuda: the census "
          f"and ladder end on {eng.impl} ({t_ladder:.1f} s with the ladder's "
          f"tile attempts), overflow {int(runs[0].overflow)}, two runs "
          f"bitwise equal: {same}; particle 0 ({x:.4f}, {y:.4f}), {c} "
          f"collisions (golden s3, f64: {GOLDEN_S3}; f32 not held to it); "
          f"sweep launches {launches}", flush=True)
    if eng.impl != "sweep" or int(runs[0].overflow) != 0 or not same:
        raise AssertionError("MEDIUM")
    # ms a step as step_ms defines it, from the second run and a run of 1.
    ms = (t_k - t_1) / (steps - 1) * 1e3
    print(f"MEDIUM f32 sweep: {ms:.4f} ms/step (run(1) {t_1:.4f} s, "
          f"run({steps}) {t_k:.4f} s)", flush=True)
    return eng, state, ms, (x, y, c)


def check_cli_fast(vec=GOLDEN_S1, kernel="fused_pairs", extra=()):
    """(f, k, y, z, ae) The CLI's fast route in-process (golden s1 through
    the census: resident; SMALL: supercell; UNEVEN: banded; on one device
    or with ``extra`` ``--mesh 4`` or ``--mesh 2x2``), with the launch
    counts set to 0 just before it:
    ``kernel`` must have launched. Returns the launch counts."""
    from particlesimulation_tpu_torch import cli

    seed, side, nc, n, steps, ex, ey, ec = vec
    args = [str(seed), f"{side:g}", str(nc), str(n), str(steps),
            "--engine", "fast", *extra]
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    torch.cuda.synchronize()
    launches = read_launches()
    lines = out.getvalue().splitlines()
    print(f"CLI {' '.join(args)} in-process on cuda: rc {rc}, {lines}, "
          f"{err.getvalue().strip()} on stderr, launches {launches}",
          flush=True)
    x, y = (float(v) for v in lines[0].split())
    if not (rc == 0 and len(lines) == 2 and int(lines[1]) == ec
            and abs(x - ex) <= GOLDEN_TOL and abs(y - ey) <= GOLDEN_TOL
            and launches[kernel] > 0):
        raise AssertionError("CLI fast")
    return launches


def time_sweeps(card, medium):
    """(g) ms a step of the sweep engine (step_ms over 20 steps; MEDIUM's
    from ``check_medium``'s runs): parity s1, f32 sweep s1, MEDIUM; each
    with its device time, idle share, launches and host syncs a step (a
    run of one step more less a run of 1; 0 syncs required)."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine

    seed, side, nc, n = GOLDEN_S1[:4]
    out = {}
    for label, eng, steps in (
            ("parity s1", _parity(seed, side, nc, n, "cuda"), 10),
            ("f32 sweep s1", Engine(SimConfig(seed, side, nc, n),
                                    impl="sweep", device="cuda"), 10),
            ("MEDIUM f32 sweep", medium[0], 1)):
        if eng is medium[0]:
            state, ms = medium[1:3]
        else:
            state = eng.init_state()
            ms, t1, tk = step_ms(eng, state, 20, reps=2)
            print(f"{label}: {ms:.4f} ms/step (run(1) {t1:.4f} s, run(21) "
                  f"{tk:.4f} s)", flush=True)
        print(f"{label}, {eng.impl}: {ms:.4f} ms/step, "
              f"{state.x.shape[0] / ms / 1e3:.4f} M particle-steps/s on "
              f"{card}", flush=True)
        out[label] = {"ms": ms, **steady_breakdown(label, eng, state, ms,
                                                   steps + 1)}
        if out[label]["syncs"] != 0:
            raise AssertionError(f"{label}: {out[label]['syncs']} host syncs "
                                 f"a step (a graphed sweep reads nothing "
                                 f"back inside a run)")
    return out


def check_adversarial_labelled(kcap):
    """(h) The labelled pass on the adversarial tiles with each label layout
    of ``adversarial.label_layouts`` (random labels and -1s; one label; every
    label distinct; runs of three between -1s; labels that return later in
    the row), v4 and v2, collide on and off: ft and count exact against the
    plain version, forces within the tolerance; every label distinct: count
    0, every ft INF, no force, where the unlabelled pass counts collisions;
    every label 0: the unlabelled pass's bits."""
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs
    from particlesimulation_tpu_torch.ops.cuda.adversarial import (
        adversarial_tiles, label_layouts)

    x, y, m, alive, pid = (torch.from_numpy(a).cuda()
                           for a in adversarial_tiles(kcap, kcap))
    layouts = {name: torch.from_numpy(lab).cuda()
               for name, lab in label_layouts(kcap, seed=kcap + 1).items()}
    tag = f"labelled adversarial K={kcap}"
    counts = {}
    for form in ("v4", "v2"):
        for collide in (True, False):
            args = (x, y, m, alive, pid, kcap, EPSILON, collide, form)
            plain = cell_pairs.fused_pairs(*args)
            for name, sub in layouts.items():
                where = f"{tag} {form} collide={collide} labels {name}"
                got = cell_pairs.fused_pairs(*args, sub=sub)
                ref = cell_pairs.fused_pairs_ref(*args, sub=sub)
                _check_collisions((got[2], got[3]), (ref[2], ref[3]), where,
                                  planted=False)
                m_post = torch.where(ref[3] != cell_pairs.INF, 0.0, m)
                _force_err(got[:2], ref[:2],
                           _term_sums(x, y, m_post, form, sub=sub), kcap,
                           where)
                if name == "distinct" and (
                        int(got[2]) != 0
                        or not bool((got[3] == cell_pairs.INF).all())
                        or bool(got[0].abs().max() > 0)
                        or (collide and int(plain[2]) == 0)):
                    raise AssertionError(f"{where}: distinct labels "
                                         f"collided or pulled")
                if name == "one" and not all(
                        torch.equal(a, b) for a, b in zip(got, plain)):
                    raise AssertionError(f"{where}: all labels 0 differ "
                                         f"from the unlabelled pass")
                if collide and form == "v4":
                    counts[name] = int(got[2])
    # (i) The cell sums on the same tiles, each label a cell of its row.
    for name, sub in layouts.items():
        nl = int(sub.max()) + 1
        row = torch.arange(sub.shape[0], device="cuda")[:, None]
        cell = torch.where(sub >= 0, row * nl + sub, -1).to(torch.int32)
        args = (m, m * x, m * y, cell, sub.shape[0] * nl)
        got = cell_pairs.supercell_cell_sums(*args)
        again = cell_pairs.supercell_cell_sums(*args)
        cpu = cell_pairs.supercell_cell_sums_ref(
            *(a.cpu() for a in args[:4]), args[4])
        if not all(torch.equal(a, b) and torch.equal(a.cpu(), c)
                   for a, b, c in zip(got, again, cpu)):
            raise AssertionError(f"{tag} cell sums, labels {name}: not "
                                 f"itself or the CPU plain version bit for "
                                 f"bit")
    torch.cuda.synchronize()
    print(f"{tag}: v4, v2, collide on and off, labels "
          f"{', '.join(layouts)}: ft and count exact (v4 counts "
          f"{counts}), forces within the tolerance; distinct labels: count "
          f"0, every ft INF, no force; all labels 0 = the unlabelled pass "
          f"bit for bit; cell sums (a cell a label and row) = itself and "
          f"the CPU plain version bit for bit", flush=True)


def v4_centre_error(tiles, sub):
    """(h) The labelled kernel's v2 and v4 forces (collide off) on a path's
    tiles against an f64 truth over the pairs of equal labels: the median
    and largest relative error over slots with a force, as
    tests/test_dense_kernels.py::test_v4_quantization_study measures it.
    The v4 centre is the mean of the row's used slots, S cells wide."""
    from particlesimulation_tpu_torch.config import EPSILON, G
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs

    x, y, m, alive, pid = tiles
    kcap = x.shape[1]
    got = {form: cell_pairs.fused_pairs(x, y, m, alive, pid, kcap, EPSILON,
                                        collide=False, force_form=form,
                                        sub=sub)[0].double()
           for form in ("v2", "v4")}
    truth = []
    for c0 in range(0, x.shape[0], 256):
        xs, ys, ms = (a[c0:c0 + 256].double() for a in (x, y, m))
        ls = sub[c0:c0 + 256]
        dx = xs[:, None, :] - xs[:, :, None]
        dy = ys[:, None, :] - ys[:, :, None]
        d2 = dx * dx + dy * dy
        pair = (d2 > 0) & (ls[:, None, :] == ls[:, :, None])
        inv3 = torch.where(pair, d2.clamp(min=1e-300) ** -1.5, 0.0)
        truth.append((G * ms[:, :, None] * ms[:, None, :] * inv3 * dx).sum(2))
    truth = torch.cat(truth)
    has = truth != 0
    out = {}
    for form, f in got.items():
        rel = ((f - truth).abs() / truth.abs())[has]
        out[form] = (float(rel.median()), float(rel.max()))
    d = ((got["v4"] - got["v2"]).abs() / got["v2"].abs())[has]
    print(f"v4 row-wide centre on SMALL's tiles ({int(has.sum())} slots with "
          f"a pair force): relative error against f64, median / max: v2 "
          f"{out['v2'][0]:.3e} / {out['v2'][1]:.3e}, v4 {out['v4'][0]:.3e} / "
          f"{out['v4'][1]:.3e}; |v4 - v2|/|v2| median {float(d.median()):.3e}"
          f", max {float(d.max()):.3e}", flush=True)
    return out


def true_cells(tiles, sub, cfg):
    """Each labelled slot's cell on the true grid, -1 for the others."""
    from particlesimulation_tpu_torch.ops import resident as res

    cx, cy, _ = res.cell_of(tiles[0], tiles[1], cfg.side, cfg.ncside)
    return torch.where(sub >= 0, cy * cfg.ncside + cx, -1).to(torch.int32)


def check_cell_sums(where, tiles, cell, ncells):
    """(i) The cell sums kernel on a path's tiles and its cell ids (-1 for
    an unbinned slot) onto ``ncells`` cells: within rtol 1e-6 of the plain
    version on the card, bit for bit equal to the plain version on the CPU
    (slot order) and to a second run of itself; timed, with its bound, and
    its zeroing and its kernel timed apart."""
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs
    from particlesimulation_tpu_torch.ops.cuda.launch_sweep import _cell_sums

    x, y, m, _, _ = tiles
    args = (m, m * x, m * y, cell, ncells)
    got = cell_pairs.supercell_cell_sums(*args)
    again = cell_pairs.supercell_cell_sums(*args)
    ref = cell_pairs.supercell_cell_sums_ref(*args)
    cpu = cell_pairs.supercell_cell_sums_ref(*(a.cpu() for a in args[:4]),
                                             ncells)
    torch.cuda.synchronize()
    tag = f"supercell_cell_sums {where} {tuple(x.shape)}"
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{tag}: two runs differ")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(got, cpu)):
        raise AssertionError(f"{tag}: differs from the plain version on "
                             f"the CPU")
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    if not all(bool(((a - b).abs() <= 1e-6 * b.abs()).all())
               for a, b in zip(got, ref)):
        raise AssertionError(f"{tag}: off by {err}")
    bound_ms, bound_by, _ = _bound(16 * x.numel() + 12 * ncells, 0, 0)
    rec = {"max_abs_err": err,
           **_kernel_times(lambda: cell_pairs.supercell_cell_sums(*args),
                           lambda: cell_pairs.supercell_cell_sums_ref(*args)),
           "bound_ms": bound_ms, "bound_by": bound_by, "sfu_ms": 0.0,
           **_cell_sums_library(args, ref)}
    # The wrapper's two launches apart: zeroing the (3, ncells) output, and
    # the kernel that writes the rows' cells into it.
    warps = cell_pairs.cell_sums_launch(x.shape[1])
    for key, parts in (("zero_device_ms", 1), ("sums_device_ms", 2)):
        rec[key] = device_ms(lambda: _cell_sums(args, warps, parts), 20)
    print(f"{tag}: device ms apart: zeroing "
          f"{rec['zero_device_ms']:.4f} (its bound "
          f"{12 * ncells / PEAK_BYTES * 1e3:.4f}), the kernel "
          f"{rec['sums_device_ms']:.4f} (reads alone "
          f"{16 * x.numel() / PEAK_BYTES * 1e3:.4f})", flush=True)
    _report(f"{tag}: {int((got[0] > 0).sum())} cells with mass; = itself "
            f"and the CPU plain version bit for bit, rtol 1e-6 of the card's",
            rec)
    print(f"{tag}: library call (one index_add_ of the stacked sources) "
          f"{rec['library_ms']:.4f} ms a call ({rec['library_device_ms']:.4f}"
          f" device), deterministic {rec['library_det_ms']:.4f} ms "
          f"({rec['library_det_device_ms']:.4f} device)", flush=True)
    return rec


def _cell_sums_library(args, ref):
    """The library call that computes the cell sums: one ``index_add_`` of
    the stacked (3, slots) sources into a (3, ncells + 1) output, unbinned
    slots into the extra column. Held to the plain version (rtol 1e-6) and
    timed as it runs by default (atomics, any order) and under
    ``torch.use_deterministic_algorithms`` (the same bits in every run, as
    the kernel gives). The port never calls it."""

    mf, mfx, mfy, cell, ncells = args
    src = torch.stack((mf, mfx, mfy)).reshape(3, -1)
    idx = cell.reshape(-1).to(torch.int64)
    idx = torch.where(idx >= 0, idx, ncells)

    def library():
        out = torch.zeros((3, ncells + 1), dtype=torch.float32,
                          device=mf.device)
        return out.index_add_(1, idx, src)

    was = torch.are_deterministic_algorithms_enabled()
    rec = {}
    try:
        for key, det in (("library", False), ("library_det", True)):
            torch.use_deterministic_algorithms(det)
            got = library()[:, :ncells]
            if not all(bool(((a - b).abs() <= 1e-6 * b.abs()).all())
                       for a, b in zip(got, ref)):
                raise AssertionError(f"cell sums' {key} call disagrees with "
                                     f"the plain version")
            rec[f"{key}_ms"] = _timed(library, 20)
            rec[f"{key}_device_ms"] = device_ms(library, 20)
    finally:
        torch.use_deterministic_algorithms(was)
    return rec


def check_small(card):
    """(h)-(l) SMALL through the census on the supercell engine. Returns
    the records of the labelled kernel (v4, collide on) and the cell sums
    kernel, and the launch counts of the path's run and of the CLI's."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine
    from particlesimulation_tpu_torch.ops.supercell import make_supercell_run

    t0 = time.perf_counter()
    seed, side, nc, n, steps = SMALL
    cfg = SimConfig(seed, side, nc, n)
    for kcap in (32, 64, 160, 288, 1024):
        check_adversarial_labelled(kcap)
    eng = Engine(cfg, device="cuda")
    state = eng.init_state()
    out, launches = check_golden(
        "SMALL supercell", eng, state, steps, SMALL_10,
        ["fused_pairs_sub", "supercell_cell_sums", *SC_MONOPOLE])
    forbid_launches("SMALL supercell", launches, STENCIL_KERNELS)
    if eng.impl != "supercell" or eng._supercell_factor() != SMALL_S:
        raise AssertionError(f"SMALL: {eng.impl}, S {eng._supercell_factor()}")
    print(f"SMALL: the census's route {eng.impl}, S {eng._supercell_factor()} "
          f"({eng._sc_rows()} rows), kcap {eng.kcap}", flush=True)
    sweep = Engine(cfg, impl="sweep", device="cuda")
    ref = sweep.run(sweep.init_state(), steps)
    compare_runs("SMALL 10 steps, supercell vs the f32 sweep on cuda",
                 (int(out.collisions), out, side),
                 (int(ref.collisions), ref, side), 1e-3 / side, None)
    _, pair_tiles, run = make_supercell_run(cfg, eng.kcap, eng._supercell_factor())
    check_no_sync("supercell", run, state)
    *tiles, sub = pair_tiles(state, steps)
    recs = {kind: fused_record("SMALL tiles", tiles, *kind, planted=False,
                               sub=sub)
            for kind in (("v4", True), ("v4", False), ("v2", True))}
    v4_centre_error(tiles, sub)
    sums = check_cell_sums("SMALL tiles", tiles, true_cells(tiles, sub, cfg),
                           cfg.ncells)
    check_gpu_vs_cpu(7, 5.0, 25, 400, 20, impl="supercell")
    cli_launches = check_cli_fast(SMALL + SMALL_10, "fused_pairs_sub")
    ms, t1, t21 = step_ms(eng, state, 20)
    print(f"SMALL supercell {n} particles, kcap {eng.kcap}: {ms:.4f} "
          f"ms/step, {n / ms / 1e3:.2f} M particle-steps/s (run(1) {t1:.4f} "
          f"s, run(21) {t21:.4f} s) on {card}", flush=True)
    times = device_breakdown("SMALL supercell", eng, state, ms)
    if times["syncs"] != 0:
        raise AssertionError(f"SMALL: {times['syncs']} syncs a step")
    print(f"supercell phases: {time.perf_counter() - t0:.1f} s; per step "
          f"{json.dumps({'ms': ms, **times})}", flush=True)
    return recs[("v4", True)], sums, launches, cli_launches


def band_lanes(plan, tiles):
    """(p) Per band, from the tiles its pair pass takes: the used slots
    (m > 0) a row c, the slot fill Σc/(rows·K) and the share of the pair
    lanes the function needs, Σc²/(rows·K²); then that share over the plan
    and over one tier of K = 864 (the dense engine at UNEVEN)."""
    c2 = lanes = 0.0
    for (r0, rw, k), (_, _, m, _, _) in zip(plan, tiles):
        c = (m > 0).sum(1).double()
        c2 += float((c * c).sum())
        lanes += float(c.numel()) * k * k
        print(f"band rows {r0}-{r0 + rw - 1}, K {k}: {int(c.sum())} "
              f"particles, max {int(c.max())} a cell, fill "
              f"{float(c.sum()) / (c.numel() * k):.3f}, pair lanes needed "
              f"{float((c * c).sum()) / (c.numel() * k * k):.3f}", flush=True)
    cells = sum(t[0].shape[0] for t in tiles)
    print(f"pair lanes needed over the plan {c2 / lanes:.4f}; over one tier "
          f"of K = 864 {c2 / (cells * 864.0 ** 2):.4f}", flush=True)
    return c2 / lanes


def check_banded(card, tiered, dense):
    """(m)-(r) The banded engine: UNEVEN through the census, against dense
    and the CPU, its fused kernel on its own band tiles, its step times
    beside the tiered and dense engines' (``tiered``, ``dense``: (engine,
    state) at UNEVEN); then N = 1e7 on the streaming route, against
    resident. Returns the path's launch counts and the two band records."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine
    from particlesimulation_tpu_torch.ops.banded import (make_banded_run,
                                                         uniform_band_plan)
    from particlesimulation_tpu_torch.ops.cuda.launch_sweep import (
        UNEVEN_BANDS, band_tiles)

    t0 = time.perf_counter()
    un = SimConfig(*UNEVEN)
    eng = Engine(un, device="cuda")
    state = eng.init_state()
    if eng.impl != "banded" or eng._band_plan != UNEVEN_BANDS:
        raise AssertionError(f"UNEVEN census: {eng.impl} {eng._band_plan}")
    _, launches = check_golden("UNEVEN banded", eng, state, 2, UNEVEN_2,
                               ["fused_pairs", *ADVANCE_KERNELS])
    check_advance_launches("UNEVEN banded", _tile_phases(
        make_banded_run, un, UNEVEN_BANDS), state)
    check_step("UNEVEN banded", eng, state, 30, exact=False)
    runs = []
    for e in (eng, Engine(un, device="cuda", impl="dense")):
        out = e.run(state, 10)
        if e.impl not in ("banded", "dense") or int(out.overflow) != 0:
            raise AssertionError(f"UNEVEN: ran {e.impl}, overflow "
                                 f"{int(out.overflow)}")
        runs.append((int(out.collisions), out, un.side))
    compare_runs("UNEVEN 10 steps, banded vs dense on cuda", *runs, 2e-5,
                 None)
    check_no_sync("banded", make_banded_run(un, UNEVEN_BANDS)[2], state)
    check_gpu_vs_cpu(-7, 100.0, 12, 4000, 10, impl="banded",
                     plan=((0, 3, 64), (3, 3, 256), (6, 3, 256), (9, 3, 64)))
    check_gpu_vs_cpu(5, 8.0, 8, 600, 15, impl="banded",
                     plan=((0, 2, 64), (2, 2, 64), (4, 2, 64), (6, 2, 64)))

    tiles = band_tiles(un, UNEVEN_BANDS, state, 2)
    band_lanes(UNEVEN_BANDS, tiles)
    recs = {}
    for b, (_, _, k) in enumerate(UNEVEN_BANDS):
        if k in (896, 32):
            recs[k] = fused_record(f"UNEVEN banded tiles K={k}", tiles[b],
                                   "v4", True, planted=False)

    times = {}
    for label, e, st in (("banded", eng, state), ("tiered", *tiered),
                         ("dense", *dense)):
        ms, t1, t11 = step_ms(e, st, 10)
        print(f"UNEVEN {label}, kcap {e.kcap}: {ms:.4f} ms/step, "
              f"{un.n_particles / ms / 1e3:.2f} M particle-steps/s (run(1) "
              f"{t1:.4f} s, run(11) {t11:.4f} s) on {card}", flush=True)
        times[f"UNEVEN {label}"] = {"ms": ms, **device_breakdown(
            f"UNEVEN {label}", e, st, ms)}
    if times["UNEVEN banded"]["syncs"] != 0:
        raise AssertionError("UNEVEN banded: host syncs in the run")

    big = SimConfig(1, 5000.0, 316, 10_000_000)
    eng_b = Engine(big, device="cuda")
    state_b = eng_b.init_state()
    if eng_b.impl != "banded" or eng_b._band_plan != uniform_band_plan(
            316, 27, 192):
        raise AssertionError(f"1e7 census: {eng_b.impl} {eng_b._band_plan}")
    eng_r = Engine(big, device="cuda", impl="resident")
    state_r = eng_r.init_state()
    outs = []
    for label, e, st in (("1e7 banded", eng_b, state_b),
                         ("1e7 resident", eng_r, state_r)):
        out, _, _ = drive(label, e, st, 10, ["fused_pairs",
                                             *ADVANCE_KERNELS])
        outs.append((int(out.collisions), out, big.side))
    same = all(torch.equal(getattr(outs[0][1], f), getattr(outs[1][1], f))
               for f in ("x", "y", "vx", "vy", "m", "alive", "pid"))
    compare_runs(f"1e7 10 steps, banded vs resident on cuda (bitwise equal: "
                 f"{same})", *outs, 1e-6, 1e-5)
    for label, e, st in (("1e7 banded", eng_b, state_b),
                         ("1e7 resident", eng_r, state_r)):
        ms, t1, t11 = step_ms(e, st, 10)
        print(f"{label}, kcap {e.kcap}: {ms:.4f} ms/step, "
              f"{big.n_particles / ms / 1e3:.2f} M particle-steps/s (run(1) "
              f"{t1:.4f} s, run(11) {t11:.4f} s) on {card}", flush=True)
        times[label] = {"ms": ms, **device_breakdown(label, e, st, ms)}
    print(f"banded phases: {time.perf_counter() - t0:.1f} s; per step "
          f"{json.dumps(times)}", flush=True)
    return launches, recs

# Parity on the mesh, cuda against cpu bit for bit: (config, steps, D); the
# second is phase (c)'s ~156 particles a cell on an uneven split of 8 rows.
MESH_CARD_VS_CPU = (((8555, 0.05, 3, 30), 20, 3),
                    ((1, 100.0, 8, 10_000), 10, 3))
MESH_FIELDS = ("pid", "x", "y", "vx", "vy", "m", "alive")


class _Valid:
    """The valid slots of a mesh state under a single-device state's field
    names (for ``compare_runs``)."""

    def __init__(self, state):
        for f in MESH_FIELDS:
            setattr(self, f, getattr(state, f)[state.valid])


def _same_bits(label, a, b):
    """Two {field: array} views in pid order, bit for bit."""
    bad = [f for f in MESH_FIELDS if not np.array_equal(a[f], b[f])]
    if bad:
        raise AssertionError(f"{label}: {bad} differ")
    print(f"{label}: {', '.join(MESH_FIELDS)} bitwise equal", flush=True)


def check_mesh(card):
    """(s)-(x) The 1D row mesh (``parallel/sharded``) on a local mesh of the
    card at the flagship: the CLI, parity against the single device and the
    CPU, the fast mesh (resident tiles) with its fused kernel, the ladder,
    checkpoints, and the step times at D = 1, 2 and 4. Returns the fast
    mesh path's launch counts and the fused kernel's record on its tiles."""
    import tempfile

    from particlesimulation_tpu_torch.config import Precision, SimConfig
    from particlesimulation_tpu_torch.engine import Engine
    from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
    from particlesimulation_tpu_torch.parallel.sharded_resident import (
        make_sharded_resident_run)
    from particlesimulation_tpu_torch.utils import checkpointing

    t0 = time.perf_counter()
    seed, side, nc, n, steps, ex, ey, ec = GOLDEN_S1
    parity, fast = Precision.PARITY, Precision.FAST

    def mesh(d, precision=fast, device="cuda", args=GOLDEN_S1[:4]):
        return ShardedEngine(SimConfig(*args, precision=precision,
                                       n_shards=d), device=device)

    # s. The CLI through the mesh: an even and an uneven split of 100 rows.
    for d in (4, 3):
        check_cli_parity(("--mesh", str(d)))

    # t. Parity: the mesh against the single device on the card, and the
    # mesh on cuda against the mesh on cpu, bit for bit.
    single = _parity(seed, side, nc, n, "cuda")
    ss = single.run(single.init_state(), steps)
    order = torch.argsort(ss.pid)
    want = {f: getattr(ss, f)[order].cpu().numpy() for f in MESH_FIELDS}
    pm = mesh(4, parity)
    pstate = pm.init_state()
    torch.cuda.synchronize()
    reset_sweep_launches()
    pout = pm.run(pstate, steps)
    require_launches("mesh parity D=4 (golden s1)", read_sweep_launches(
        "mesh parity D=4 (golden s1)"), MIGRATE_KERNELS)
    _same_bits(f"golden s1 parity on cuda, mesh D=4 vs one device "
               f"({int(pout.collisions)} collisions)", pm.gather(pout), want)
    if not int(pout.collisions) == int(ss.collisions) == ec:
        raise AssertionError("golden s1 parity mesh: collisions")
    for args, k, d in MESH_CARD_VS_CPU:
        outs = []
        for device in ("cuda", "cpu"):
            e = mesh(d, parity, device, args)
            o = e.run(e.init_state(), k)
            outs.append((e.gather(o), int(o.collisions)))
        _same_bits(f"parity mesh D={d} {args}, {k} steps, cuda vs cpu "
                   f"({outs[0][1]} = {outs[1][1]} collisions)",
                   outs[0][0], outs[1][0])
        if outs[0][1] != outs[1][1]:
            raise AssertionError("parity mesh cuda vs cpu: collisions")

    # u. Fast: D = 4 at the flagship through the census (resident tiles).
    fm = mesh(4)
    fstate = fm.init_state()
    if fm.impl != "resident":
        raise AssertionError(f"flagship mesh census: {fm.impl}")
    fout, launches = check_golden("golden s1 mesh resident D=4", fm, fstate,
                                  steps, (ex, ey, ec),
                                  ["fused_pairs", "monopole_gathered",
                                   *STENCIL_MESH])
    rs = Engine(SimConfig(seed, side, nc, n), device="cuda")
    rout = rs.run(rs.init_state(), steps)
    compare_runs("golden s1, mesh resident D=4 vs one-device resident on "
                  "cuda", (int(fout.collisions), _Valid(fout), side),
                  (int(rout.collisions), rout, side), 1e-6, 1e-5)
    _, pair_tiles, run = make_sharded_resident_run(
        fm.config, fm.mesh, fm.kcap, fm.capacity, fm.ship_rounds)
    rec = fused_record("mesh resident D=4 tiles", pair_tiles(fstate, steps),
                       "v4", True, planted=False)
    check_no_sync("mesh resident D=4", run, fstate)

    # v. The ladder: a slab capacity below the fullest shard's count, so
    # the first attempt's epilogue overflows (CAP_OVF) for certain.
    lad = mesh(4)
    lstate = lad.init_state()
    tight = int(lstate.valid.view(4, -1).sum(1).max()) - 1000
    lad.capacity = tight
    lout = lad.run(lstate, steps)
    if lad.capacity <= tight or lad.impl != "resident":
        raise AssertionError(f"ladder: capacity {lad.capacity}, {lad.impl}")
    _same_bits(f"ladder, slab capacity {tight} -> {lad.capacity} after "
               f"CAP_OVF, vs {fm.capacity}", lad.gather(lout),
               fm.gather(fout))

    # w. Checkpoints: 2 steps, save, restore as saved (D = 4) and re-packed
    # onto D = 2, 2 more steps; against the 4 uninterrupted steps.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mid.npz")
        for prec, eng0, st0, full in ((parity, pm, pstate, pout),
                                      (fast, fm, fstate, fout)):
            mid = eng0.run(st0, 2)
            checkpointing.save_sharded_state(
                path, mid, n_shards=4, row_starts=eng0.config.row_starts)
            ref = eng0.gather(full)
            for d in (4, 2):
                e = eng0 if d == 4 else mesh(2, prec)
                out = e.run(checkpointing.restore_sharded(path, e),
                            steps - 2)
                label = (f"checkpoint {prec.value} D=4 -> D={d}, 2 + 2 "
                         f"steps vs 4")
                got = e.gather(out)
                if int(out.collisions) != int(full.collisions):
                    raise AssertionError(f"{label}: collisions")
                if prec is parity:
                    _same_bits(label, got, ref)
                elif not np.array_equal(got["alive"], ref["alive"]):
                    raise AssertionError(f"{label}: dead sets differ")
                else:
                    print(f"{label}: {int(out.collisions)} collisions, dead "
                          f"sets equal, max|dpos| "
                          f"{np.abs(got['x'] - ref['x']).max():.3e}",
                          flush=True)

    # x. Step times at D = 1, 2 and 4 in both precisions.
    times = {}
    for prec, k, dsteps in ((parity, 4, 2), (fast, 20, 10)):
        for d in (1, 2, 4):
            e, st = ((pm, pstate) if prec is parity else (fm, fstate)) \
                if d == 4 else (mesh(d, prec), None)
            st = st or e.init_state()
            # A new engine's first run captures its graphs: not timed.
            e.run(st, 0)
            ms, t1, tk = step_ms(e, st, k, reps=1 if prec is parity else 2)
            label = f"mesh {prec.value} D={d}"
            print(f"{label}, {e.impl}, kcap {e.kcap}, slab {e.capacity}: "
                  f"{ms:.4f} ms/step, {n / ms / 1e3:.2f} M particle-steps/s "
                  f"(run(1) {t1:.4f} s, run({k + 1}) {tk:.4f} s) on {card}",
                  flush=True)
            times[label] = {"ms": ms, **device_breakdown(label, e, st, ms,
                                                         dsteps)}
    if any(times[f"mesh fast D={d}"]["syncs"] != 0 for d in (1, 2, 4)):
        raise AssertionError("mesh resident: host syncs in the run")
    print(f"mesh phases: {time.perf_counter() - t0:.1f} s; per step "
          f"{json.dumps(times)}", flush=True)
    return launches, rec


# The mesh census's other routes (phases y-ad): SMALL's 130 super-rows on 4
# shards, UNEVEN's 100 columns on 4 shards, and the N scaling row's 2e7
# point on 2 shards (the streaming route).
SMALL_SC_STARTS = (0, 33, 66, 98, 130)
STREAM_2E7 = (1, 5000.0, 447, 20_000_000)
# cuda = cpu on two small configs of each route (the CPU tests' configs).
ROUTES_CARD_VS_CPU = (
    ("supercell", (5893, 0.5, 16, 200), 15, 2, None),
    ("supercell", (1, 3.0, 24, 300), 20, 3, None),
    ("banded", (-10, 3.0, 16, 600), 10, 8, ((0, 8, 96), (8, 8, 64))),
    ("banded", (17, 0.12, 13, 300), 20, 8, ((0, 6, 96), (6, 7, 96))))


def _mesh_cells(eng, tiles, sub):
    """The super-cell mesh's cell id of each labelled slot of its tiles: its
    cell on its shard's local cell grid (the owned super-rows' S cell rows
    each), shard-major; -1 for the others. Returns (cells, ncells)."""
    from particlesimulation_tpu_torch.ops import resident as res
    from particlesimulation_tpu_torch.parallel.sharded_supercell import (
        sc_row_starts)

    cfg, S = eng.config, eng._sc_factor
    nc, d = cfg.ncside, cfg.n_shards
    starts = sc_row_starts(nc // S, d)
    rows_cells = max(b - a for a, b in zip(starts, starts[1:])) * S
    row0 = torch.tensor(starts[:-1], device=tiles[0].device) * S
    shard = (torch.arange(tiles[0].shape[0], device=tiles[0].device)
             // (tiles[0].shape[0] // d))[:, None]
    cx, cy, _ = res.cell_of(tiles[0], tiles[1], cfg.side, nc)
    cell = shard * rows_cells * nc + (cy - row0[shard]) * nc + cx
    return (torch.where(sub >= 0, cell, -1).to(torch.int32),
            d * rows_cells * nc)


def _mesh_times(label, eng, state, card, k=10):
    ms, t1, tk = step_ms(eng, state, k)
    n = eng.config.n_particles
    print(f"{label}, {eng.impl}, kcap {eng.kcap}: {ms:.4f} ms/step, "
          f"{n / ms / 1e3:.2f} M particle-steps/s (run(1) {t1:.4f} s, "
          f"run({k + 1}) {tk:.4f} s) on {card}", flush=True)
    return {"ms": ms, **device_breakdown(label, eng, state, ms)}


def check_mesh_routes(card):
    """(y)-(ad) The mesh census's other routes on a local mesh of the card:
    sharded super-cell tiles at SMALL and column-sharded bands at UNEVEN
    (D = 4), the streaming route at the 2e7 point (D = 2), their kernels on
    the routes' own tiles, no host sync, cuda = cpu, both ladders, and the
    step times at D = 1, 2 and 4 beside the one-device engines'. Returns
    the paths' launch counts and the kernel records."""
    from particlesimulation_tpu_torch import engine as single
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine
    from particlesimulation_tpu_torch.ops.banded import grow_plan
    from particlesimulation_tpu_torch.ops.cuda.launch_sweep import (
        UNEVEN_BANDS)
    from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
    from particlesimulation_tpu_torch.parallel.sharded_banded_cols import (
        make_sharded_banded_cols_run)
    from particlesimulation_tpu_torch.parallel.sharded_supercell import (
        make_sharded_supercell_run, sc_row_starts)

    t0 = time.perf_counter()
    launches, recs, times = {}, {}, {}

    def mesh(args, d, **kw):
        return ShardedEngine(SimConfig(*args, n_shards=d), device="cuda",
                             **kw)

    # y. SMALL at D = 4 through the census: super-cell tiles, S = 10.
    seed, side, nc, n, steps = SMALL
    sm = mesh(SMALL[:4], 4)
    sstate = sm.init_state()
    if (sm.impl != "supercell" or sm._sc_factor != SMALL_S
            or sc_row_starts(nc // SMALL_S, 4) != SMALL_SC_STARTS):
        raise AssertionError(f"SMALL mesh census: {sm.impl}, S "
                             f"{sm._sc_factor}")
    print(f"SMALL mesh D=4: the census's route {sm.impl}, S {sm._sc_factor}, "
          f"super-rows {SMALL_SC_STARTS}, kcap {sm.kcap}", flush=True)
    sout, launches["SMALL mesh"] = check_golden(
        "SMALL mesh supercell D=4", sm, sstate, steps, SMALL_10,
        ["fused_pairs_sub", "supercell_cell_sums", *SC_MONOPOLE])
    forbid_launches("SMALL mesh supercell D=4", launches["SMALL mesh"],
                    STENCIL_KERNELS)
    one = Engine(SimConfig(*SMALL[:4]), device="cuda")
    ostate = one.init_state()
    oout = one.run(ostate, steps)
    compare_runs("SMALL 10 steps, mesh supercell D=4 vs one-device supercell "
                 "on cuda", (int(sout.collisions), _Valid(sout), side),
                 (int(oout.collisions), oout, side), 1e-6, 1e-5)
    launches["SMALL mesh CLI"] = check_cli_fast(
        SMALL + SMALL_10, "fused_pairs_sub", ("--mesh", "4"))
    _, pair_tiles, run = make_sharded_supercell_run(
        sm.config, sm.mesh, sm.kcap, sm.capacity, sm._sc_factor)
    *tiles, sub = pair_tiles(sstate, steps)
    recs["fused_pairs_sub"] = fused_record("SMALL mesh D=4 tiles", tiles,
                                           "v4", True, planted=False,
                                           sub=sub)
    recs["supercell_cell_sums"] = check_cell_sums(
        "SMALL mesh D=4 tiles", tiles, *_mesh_cells(sm, tiles, sub))
    check_no_sync("mesh supercell D=4", run, sstate)

    # z. UNEVEN at D = 4 through the census: column-sharded bands on the
    # one-device plan, 25 columns a shard.
    um = mesh(UNEVEN, 4)
    ustate = um.init_state()
    if um.impl != "banded" or um._band_plan != UNEVEN_BANDS:
        raise AssertionError(f"UNEVEN mesh census: {um.impl} {um._band_plan}")
    print(f"UNEVEN mesh D=4: the census's route {um.impl} "
          f"({um.banded_variant}), {len(um._band_plan)} bands "
          f"{um._band_plan}, {UNEVEN[2] // 4} columns a shard", flush=True)
    _, launches["UNEVEN mesh"] = check_golden(
        "UNEVEN mesh banded D=4", um, ustate, 2, UNEVEN_2,
        ["fused_pairs", "monopole_gathered", *STENCIL_MESH])
    ub = Engine(SimConfig(*UNEVEN), device="cuda")
    uout10 = um.run(ustate, 10)
    bout10 = ub.run(ub.init_state(), 10)
    if ub.impl != "banded" or int(uout10.overflow) != 0:
        raise AssertionError(f"UNEVEN: one device ran {ub.impl}")
    compare_runs("UNEVEN 10 steps, mesh banded D=4 vs one-device banded on "
                 "cuda", (int(uout10.collisions), _Valid(uout10), UNEVEN[1]),
                 (int(bout10.collisions), bout10, UNEVEN[1]), 2e-5, None)
    launches["UNEVEN mesh CLI"] = check_cli_fast(
        UNEVEN + (10, *ub.result(bout10)), "fused_pairs", ("--mesh", "4"))
    _, band_tiles, urun = make_sharded_banded_cols_run(
        um.config, um.mesh, um._band_plan, um.capacity)
    widest = max(range(len(UNEVEN_BANDS)), key=lambda b: UNEVEN_BANDS[b][2])
    recs["fused_pairs"] = fused_record(
        f"UNEVEN mesh D=4 band tiles K={UNEVEN_BANDS[widest][2]}",
        band_tiles(ustate, 2)[widest], "v4", True, planted=False)
    check_no_sync("mesh banded D=4", urun, ustate)

    # aa. The streaming route at the 2e7 point on 2 shards, against
    # resident tiles on the same mesh.
    big = mesh(STREAM_2E7, 2)
    bstate = big.init_state()
    occ_bytes = single._STREAM_BYTES
    k_est = big._band_plan[0][2] if big._band_plan else None
    print(f"2e7 mesh D=2: the census's route {big.impl}, tile state "
          f"{STREAM_2E7[2] ** 2 * (k_est or 0) * 25 // 2 >> 20} MB a shard "
          f"at K {k_est} (threshold {occ_bytes >> 20} MB), plan "
          f"{big._band_plan}", flush=True)
    if big.impl != "banded" or len(big._band_plan) < 2:
        raise AssertionError(f"2e7 mesh census: {big.impl}")
    outs = []
    out, _, launches["2e7 mesh banded"] = drive(
        "2e7 mesh banded D=2", big, bstate, 5,
        ["fused_pairs", "monopole_gathered", *STENCIL_MESH])
    outs = [(int(out.collisions), _Valid(out), STREAM_2E7[1])]
    del big, bstate, out
    res_mesh = mesh(STREAM_2E7, 2, impl="resident")
    out, _, _ = drive("2e7 mesh resident D=2", res_mesh,
                      res_mesh.init_state(), 5, ["fused_pairs"])
    outs.append((int(out.collisions), _Valid(out), STREAM_2E7[1]))
    del res_mesh, out
    compare_runs("2e7 5 steps, mesh banded D=2 vs mesh resident D=2 on cuda",
                 *outs, 1e-6, 1e-5)
    del outs

    # ab. cuda = cpu on two small configs of each route.
    for impl, args, k, d, plan in ROUTES_CARD_VS_CPU:
        runs = []
        for device in ("cuda", "cpu"):
            e = ShardedEngine(SimConfig(*args, n_shards=d), impl=impl,
                              device=device)
            if plan is not None:
                e._band_plan = plan
            o = e.run(e.init_state(), k)
            if e.impl != impl or int(o.overflow) != 0:
                raise AssertionError(f"cuda vs cpu: {impl} ran {e.impl}")
            runs.append((int(o.collisions), _Valid(o), args[1]))
        compare_runs(f"cuda vs cpu, mesh {impl} D={d} {args}, {k} steps",
                     *runs, 1e-6, 1e-5)

    # ac. The ladders: tiles too small at SMALL, bands too narrow at UNEVEN;
    # each ends on the untight run's count and dead set.
    for label, e, st, ref in (
            ("SMALL mesh D=4, kcap 32", mesh(SMALL[:4], 4, kcap=32), None,
             sout),
            ("UNEVEN mesh D=4, plan at 0.7 K", mesh(UNEVEN, 4), None,
             uout10)):
        st = e.init_state()
        if e.impl == "banded":
            e._band_plan = tuple(map(tuple, grow_plan(UNEVEN_BANDS, 0.7)))
        before = e._band_plan or e.kcap
        o = e.run(st, 10 if e.impl == "banded" else steps)
        after = e._band_plan or e.kcap
        print(f"ladder {label}: {before} -> {after}, ended on {e.impl}",
              flush=True)
        if before == after or int(o.overflow) != 0:
            raise AssertionError(f"ladder {label}: did not grow")
        compare_runs(f"ladder {label} vs the untight run",
                     (int(o.collisions), _Valid(o), e.config.side),
                     (int(ref.collisions), _Valid(ref), e.config.side),
                     2e-5, None)

    # ad. Step times at D = 1, 2 and 4 beside the one-device engines'.
    for name, args, eng0, st0, m4, s4 in (
            ("SMALL", SMALL[:4], one, ostate, sm, sstate),
            ("UNEVEN", UNEVEN, ub, None, um, ustate)):
        times[f"{name} one device"] = _mesh_times(
            f"{name} one device", eng0, st0 or eng0.init_state(), card)
        for d in (1, 2, 4):
            e, st = (m4, s4) if d == 4 else (mesh(args, d), None)
            st = st or e.init_state()
            times[f"{name} mesh D={d}"] = _mesh_times(
                f"{name} mesh D={d}", e, st, card)
    if any(t["syncs"] != 0 for t in times.values()):
        raise AssertionError("mesh routes: host syncs in a run")
    print(f"mesh route phases: {time.perf_counter() - t0:.1f} s; per step "
          f"{json.dumps(times)}", flush=True)
    return launches, recs


# The 2D mesh and the block-cyclic bands (phases ae-ak). Parity on the 2D
# mesh, cuda against cpu bit for bit: (config, steps, mesh shape); the
# first uneven on both axes (2 + 2 + 1 columns, 3 + 2 rows).
MESH2D_CARD_VS_CPU = (((17, 0.12, 5, 120), 20, (2, 3)),
                      ((1, 100.0, 8, 10_000), 10, (2, 2)))


def check_mesh2d(card):
    """(ae)-(ak) The 2D rectangle mesh (``parallel/sharded2d``) at the
    flagship on a local (2, 2) mesh of the card, the census's delegation
    under it, and the block-cyclic bands (``parallel/sharded_banded``) at
    UNEVEN on 4 shards: the CLI, parity bit for bit, rectangle tiles with
    the fused kernel on their own tiles, the ladders, the step times.
    Returns the paths' launch counts and the kernel record."""
    from particlesimulation_tpu_torch.config import Precision, SimConfig
    from particlesimulation_tpu_torch.engine import Engine
    from particlesimulation_tpu_torch.ops.banded import grow_plan
    from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
    from particlesimulation_tpu_torch.parallel.sharded2d import (
        Sharded2DEngine)
    from particlesimulation_tpu_torch.parallel.sharded2d_resident import (
        make_sharded2d_resident_run)
    from particlesimulation_tpu_torch.parallel.sharded_banded import (
        make_sharded_banded_run)

    t0 = time.perf_counter()
    seed, side, nc, n, steps, ex, ey, ec = GOLDEN_S1
    parity, fast = Precision.PARITY, Precision.FAST
    launches, times = {}, {}

    def mesh2d(shape, precision=fast, device="cuda", args=GOLDEN_S1[:4],
               **kw):
        return Sharded2DEngine(SimConfig(
            *args, precision=precision, n_shards=shape[0] * shape[1],
            mesh_shape=shape), device=device, **kw)

    def cyclic(**kw):
        return ShardedEngine(SimConfig(*UNEVEN, n_shards=4),
                             impl="banded-cyclic", device="cuda", **kw)

    # ae. The CLI through the 2D mesh: parity as a subprocess, fast
    # in-process (the fused kernel launched).
    check_cli_parity(("--mesh", "2x2"))
    launches["2D CLI fast"] = check_cli_fast(extra=("--mesh", "2x2"))

    # af. Parity at (2, 2) against one device, bit for bit; cuda = cpu.
    single = _parity(seed, side, nc, n, "cuda")
    ss = single.run(single.init_state(), steps)
    order = torch.argsort(ss.pid)
    want = {f: getattr(ss, f)[order].cpu().numpy() for f in MESH_FIELDS}
    pm = mesh2d((2, 2), parity)
    pstate = pm.init_state()
    torch.cuda.synchronize()
    reset_sweep_launches()
    pout = pm.run(pstate, steps)
    require_launches("mesh parity (2, 2) (golden s1)", read_sweep_launches(
        "mesh parity (2, 2) (golden s1)"), MIGRATE_KERNELS)
    _same_bits(f"golden s1 parity on cuda, mesh (2, 2) vs one device "
               f"({int(pout.collisions)} collisions)", pm.gather(pout), want)
    if not (pm.impl == "sweep" and int(pout.collisions) == ec):
        raise AssertionError("golden s1 parity 2D mesh")
    for args, k, shape in MESH2D_CARD_VS_CPU:
        outs = []
        for device in ("cuda", "cpu"):
            e = mesh2d(shape, parity, device, args)
            o = e.run(e.init_state(), k)
            outs.append((e.gather(o), int(o.collisions)))
        _same_bits(f"parity mesh {shape} {args}, {k} steps, cuda vs cpu "
                   f"({outs[0][1]} = {outs[1][1]} collisions)",
                   outs[0][0], outs[1][0])
        if outs[0][1] != outs[1][1]:
            raise AssertionError("parity 2D mesh cuda vs cpu: collisions")

    # ag. Fast at (2, 2): rectangle tiles by the census.
    fm = mesh2d((2, 2))
    fstate = fm.init_state()
    if fm.impl != "resident" or fm.target() is not fm:
        raise AssertionError(f"flagship 2D census: {fm.impl}")
    fout, launches["2D resident"] = check_golden(
        "golden s1 mesh resident (2, 2)", fm, fstate, steps, (ex, ey, ec),
        ["fused_pairs", "monopole_gathered", *STENCIL_MESH])
    rs = Engine(SimConfig(seed, side, nc, n), device="cuda")
    rout = rs.run(rs.init_state(), steps)
    compare_runs("golden s1, mesh resident (2, 2) vs one-device resident on "
                 "cuda", (int(fout.collisions), _Valid(fout), side),
                 (int(rout.collisions), rout, side), 1e-6, 1e-5)
    _, pair_tiles, run = make_sharded2d_resident_run(
        fm.config, fm.mesh, fm.dec_r, fm.dec_c, fm.kcap, fm.capacity,
        fm.ship_rounds)
    rec = fused_record("mesh resident (2, 2) tiles",
                       pair_tiles(fstate, steps), "v4", True, planted=False)
    check_no_sync("mesh resident (2, 2)", run, fstate)

    # ah. The census under (2, 2): SMALL to super-cells (the 1D D = 4
    # route's bits), UNEVEN to column bands.
    sm = mesh2d((2, 2), args=SMALL[:4])
    sstate = sm.init_state()
    if sm.impl != "supercell" or sm.target() is sm:
        raise AssertionError(f"SMALL 2D census: {sm.impl}")
    sout, _, launches["SMALL 2D -> supercell"] = drive(
        "SMALL mesh (2, 2) -> supercell D=4", sm, sstate, SMALL[4],
        ["fused_pairs_sub", "supercell_cell_sums", *SC_MONOPOLE])
    forbid_launches("SMALL mesh (2, 2) -> supercell D=4",
                    launches["SMALL 2D -> supercell"], STENCIL_KERNELS)
    one_d = ShardedEngine(SimConfig(*SMALL[:4], n_shards=4), device="cuda")
    _same_bits("SMALL 10 steps, mesh (2, 2) delegated vs 1D D=4",
               sm.gather(sout), one_d.gather(one_d.run(one_d.init_state(),
                                                       SMALL[4])))
    um2 = mesh2d((2, 2), args=UNEVEN)
    um2.init_state()
    if um2.impl != "banded" or um2.target().banded_variant != "cols":
        raise AssertionError(f"UNEVEN 2D census: {um2.impl}")
    print(f"UNEVEN mesh (2, 2): the census delegates to {um2.impl} "
          f"({um2.target().banded_variant}), plan "
          f"{um2.target()._band_plan}", flush=True)
    del sm, sstate, sout, one_d, um2

    # ai. UNEVEN at D = 4 on block-cyclic bands.
    cm = cyclic()
    cstate = cm.init_state()
    plan = cm._band_plan
    print(f"UNEVEN cyclic D=4: {cm.impl} ({cm.banded_variant}), "
          f"{len(plan)} bands {plan}", flush=True)
    if cm.impl != "banded" or cm.banded_variant != "cyclic":
        raise AssertionError(f"UNEVEN cyclic: {cm.impl}")
    _, launches["UNEVEN cyclic"] = check_golden(
        "UNEVEN mesh banded-cyclic D=4", cm, cstate, 2, UNEVEN_2,
        ["fused_pairs", "monopole_gathered", *STENCIL_MESH])
    cout10 = cm.run(cstate, 10)
    if cm._band_plan != plan or cm.impl != "banded":
        print(f"UNEVEN cyclic D=4 ended on {cm.impl}, plan {cm._band_plan}",
              flush=True)
    ub = Engine(SimConfig(*UNEVEN), device="cuda")
    bout10 = ub.run(ub.init_state(), 10)
    compare_runs("UNEVEN 10 steps, mesh banded-cyclic D=4 vs one-device "
                 "banded on cuda",
                 (int(cout10.collisions), _Valid(cout10), UNEVEN[1]),
                 (int(bout10.collisions), bout10, UNEVEN[1]), 2e-5, None)
    _, band_tiles, crun = make_sharded_banded_run(
        cm.config, cm.mesh, cm._band_plan, cm.capacity, cm.ship_rounds)
    widest = max(range(len(cm._band_plan)),
                 key=lambda b: cm._band_plan[b][2])
    fused_record(f"UNEVEN cyclic D=4 band tiles K={cm._band_plan[widest][2]}",
                 band_tiles(cstate, 2)[widest], "v4", True, planted=False)
    check_no_sync("mesh banded-cyclic D=4", crun, cstate)
    del ub, bout10

    # aj. The ladders, each ending on the untight run's count and dead set.
    lad = mesh2d((2, 2), kcap=32)
    lout = lad.run(lad.init_state(), steps)
    slab = mesh2d((2, 2))
    sstate = slab.init_state()
    tight = int(sstate.valid.view(4, -1).sum(1).max()) - 1000
    slab.capacity = tight
    sout = slab.run(sstate, steps)
    grown = cyclic()
    gstate = grown.init_state()
    grown._band_plan = tuple(map(tuple, grow_plan(plan, 0.7)))
    gout = grown.run(gstate, 10)
    for label, e, o, ref, before, after in (
            ("2D resident (2, 2), kcap 32", lad, lout, fout, 32, lad.kcap),
            (f"2D resident (2, 2), slab {tight}", slab, sout, fout, tight,
             slab.capacity),
            ("UNEVEN cyclic D=4, plan at 0.7 K", grown, gout, cout10,
             tuple(map(tuple, grow_plan(plan, 0.7))), grown._band_plan)):
        print(f"ladder {label}: {before} -> {after}, ended on {e.impl}",
              flush=True)
        if before == after or int(o.overflow) != 0:
            raise AssertionError(f"ladder {label}: did not grow")
        compare_runs(f"ladder {label} vs the untight run",
                     (int(o.collisions), _Valid(o), e.config.side),
                     (int(ref.collisions), _Valid(ref), e.config.side),
                     2e-5, None)
    del lad, lout, slab, sstate, sout, grown, gstate, gout

    # ak. Step times: the flagship's fast mesh at (2, 2), (4, 1), (1, 4)
    # against 1D D = 4; parity at (2, 2); UNEVEN cyclic against column
    # bands at D = 4.
    for label, e, st in (
            ("mesh fast (2, 2)", fm, fstate),
            ("mesh fast (4, 1)", mesh2d((4, 1)), None),
            ("mesh fast (1, 4)", mesh2d((1, 4)), None),
            ("mesh fast 1D D=4", ShardedEngine(SimConfig(*GOLDEN_S1[:4],
                                                         n_shards=4),
                                               device="cuda"), None),
            ("UNEVEN banded-cyclic D=4", cm, cstate),
            ("UNEVEN banded-cols D=4", ShardedEngine(
                SimConfig(*UNEVEN, n_shards=4), device="cuda"), None)):
        st = st or e.init_state()
        e.run(st, 1)
        times[label] = _mesh_times(label, e, st, card,
                                   k=10 if "UNEVEN" in label else 20)
    ms, t1, tk = step_ms(pm, pstate, 4, reps=1)
    print(f"mesh parity (2, 2), {pm.impl}: {ms:.4f} ms/step (run(1) "
          f"{t1:.4f} s, run(5) {tk:.4f} s) on {card}", flush=True)
    times["mesh parity (2, 2)"] = {
        "ms": ms, **device_breakdown("mesh parity (2, 2)", pm, pstate, ms, 2)}
    if any(t["syncs"] != 0 for k, t in times.items() if "parity" not in k):
        raise AssertionError("2D mesh / cyclic: host syncs in a tile run")
    print(f"2D mesh and cyclic phases: {time.perf_counter() - t0:.1f} s; "
          f"per step {json.dumps(times)}", flush=True)
    return launches, rec


def _direct_planted(n, side, seed, dtype, pairs=()):
    """(x, y, m, alive) on the card: n particles uniform on the box with
    the reference's mass scale at ncside 1, the planted cases of
    ``plant_direct_cases`` (and a pair at the last two slots from n = 20),
    and the slots that must die."""
    from particlesimulation_tpu_torch.config import EPSILON2, G
    from particlesimulation_tpu_torch.ops.cuda.adversarial import (
        plant_direct_cases)

    rng = np.random.default_rng(seed)
    x, y = rng.uniform(0.0, side, (2, n))
    m = rng.uniform(size=n) * 0.01 / n / G * EPSILON2
    alive = np.ones(n, bool)
    pairs = tuple(pairs) + (((n - 2, n - 1),) if n >= 20 else ())
    planted = plant_direct_cases(x, y, np.zeros(n), np.zeros(n), m, alive,
                                 side, pairs)
    out = [torch.tensor(a, dtype=dtype, device="cuda") for a in (x, y, m)]
    return (*out, torch.tensor(alive, device="cuda"),
            [s for s in planted if s not in (9, 10)])


def _direct_exact(x, y, m, side):
    """(exact, mag), each (2, N) float64: per particle and axis, the plain
    version's own terms (its arithmetic in x's type) summed in float64,
    and the sum of their magnitudes S."""
    from particlesimulation_tpu_torch.config import G

    chunk = 512
    sidet = torch.full((), side, dtype=x.dtype, device=x.device)
    g = torch.full((), G, dtype=x.dtype, device=x.device)
    exact = torch.empty(2, x.numel(), dtype=torch.float64, device=x.device)
    mag = torch.empty_like(exact)
    for i0 in range(0, x.numel(), chunk):
        d = []
        for a in (x, y):
            da = a[None, :] - a[i0:i0 + chunk, None]
            d.append(da - sidet * torch.round(da / sidet))
        d2 = d[0] * d[0] + d[1] * d[1]
        nz = d2 > 0
        inv = torch.where(nz, torch.rsqrt(torch.where(nz, d2, 1.0)), 0.0)
        s = (g * m[i0:i0 + chunk, None]) * m[None, :] * (inv * inv * inv)
        for k in range(2):
            t = (s * d[k]).double()
            exact[k, i0:i0 + chunk] = t.sum(1)
            mag[k, i0:i0 + chunk] = t.abs().sum(1)
    return exact, mag


def _direct_consts():
    """(kTile, kForceSplit) of csrc/direct_nbody.cu."""
    from particlesimulation_tpu_torch.ops.cuda.direct_nbody import (
        source_constants)

    c = source_constants()
    return c["kTile"], c["kForceSplit"]


def _direct_chain(n):
    """The most force terms one thread of the kernel sums in order for a
    receiver: its part's slice, kTile/kForceSplit wide, of every tile."""
    tile, split = _direct_consts()
    width = tile // split
    return n // tile * width + min(width, n % tile)


def _direct_force_tol(mag, dtype):
    """Per particle and axis, ((K + 16 + P - 1)·u + (N - 1)·2⁻⁵³)·S (the
    module docstring)."""
    n = mag.shape[1]
    u = 2.0 ** -24 if dtype == torch.float32 else 2.0 ** -53
    split = _direct_consts()[1]
    return ((_direct_chain(n) + 16 + split - 1) * u
            + (n - 1) * 2.0 ** -53) * mag


def _direct_force_err(got, exact, mag):
    """(max |got - exact| over both axes, its largest err/tol)."""
    tol = _direct_force_tol(mag, got[0].dtype).clamp(min=1e-300)
    err = (torch.stack(got).double() - exact).abs()
    return float(err.max()), float((err / tol).max())


def _check_direct_forces(got, plain, x, y, m, side, tag):
    """The kernel's forces against the plain version's terms summed in
    float64: raises where err > tol. Returns (max error, largest err/tol,
    the plain version's own largest err/tol, mag)."""
    exact, mag = _direct_exact(x, y, m, side)
    ferr, ratio = _direct_force_err(got, exact, mag)
    if ratio > 1:
        raise AssertionError(f"{tag}: force off by up to {ferr} (err/tol "
                             f"{ratio})")
    return ferr, ratio, _direct_force_err(plain, exact, mag)[1], mag


def _tail_forces(x, y, m, side, lo):
    """(2, N) float64: the force on every particle from partners [lo, N)
    alone, the plain version's terms."""
    from particlesimulation_tpu_torch.config import G

    x, y, m = (a.double() for a in (x, y, m))
    sidet = torch.full((), side, dtype=torch.float64, device=x.device)
    d = []
    for a in (x, y):
        da = a[None, lo:] - a[:, None]
        d.append(da - sidet * torch.round(da / sidet))
    d2 = d[0] * d[0] + d[1] * d[1]
    w = (G * m[:, None] * m[None, lo:]
         * torch.where(d2 > 0, d2.clamp(min=1e-300) ** -1.5, 0.0))
    return torch.stack([(w * dk).sum(1) for dk in d])


def _check_partners(got, ref, tag, must_die=()):
    """The kernel's first partners against the plain version's, exactly;
    the planted slots must die. Returns (deaths, count)."""
    from particlesimulation_tpu_torch.ops.cuda.direct_nbody import (
        first_pair_outcome)

    if not torch.equal(got, ref):
        raise AssertionError(f"{tag}: partners differ in "
                             f"{int((got != ref).sum())} slots")
    died, count = first_pair_outcome(ref)
    if must_die and not bool(died[list(must_die)].all()):
        raise AssertionError(f"{tag}: a planted slot did not die")
    return int(died.sum()), int(count)


def _direct_bound(ops, sfu, nbytes, dtype):
    """(bound_ms, bound_by, sfu_ms): the larger of the bytes' time, the
    operations' time at the type's rate and, in float32, the
    special-function operations' at the SFU rate."""
    mem_ms = nbytes / PEAK_BYTES * 1e3
    f32 = dtype == torch.float32
    ops_ms = ops / (PEAK_F32 if f32 else PEAK_F64) * 1e3
    sfu_ms = sfu / PEAK_SFU * 1e3 if f32 else 0.0
    bound = max(mem_ms, ops_ms, sfu_ms)
    return bound, "bytes" if bound == mem_ms else "operations", sfu_ms


def _direct_force_bound(x, m):
    """x, y, m read and fx, fy written once; 22 f32 operations and one
    special-function one (the rsqrt) for each ordered pair of particles
    with mass."""
    used = float((m > 0).sum())
    return _direct_bound(22 * used * used, used * used,
                         5 * x.numel() * x.element_size(), x.dtype)


def _direct_candidates(x, alive, first, side):
    """Of the pairs the search needs (each alive particle's alive partners
    up to its first hit, or all of them), those whose x image alone has
    fl(dx²) < eps2: the pairs that need the full test. JAX's image, a
    block of receivers at a time."""
    from particlesimulation_tpu_torch.ops.cuda.direct_nbody import (
        _min_image, eps2_of)

    n, chunk = x.numel(), 1024
    sidet = torch.full((), side, dtype=x.dtype, device=x.device)
    idx = torch.arange(n, device=x.device)
    last = torch.where(first >= 0, first.long(), n - 1)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for i0 in range(0, n, chunk):
        i = idx[i0:i0 + chunk, None]
        d = _min_image(x[None, :], x[i0:i0 + chunk, None], sidet)
        total += ((d * d < eps2_of(x.dtype)) & alive[None, :]
                  & alive[i0:i0 + chunk, None] & (idx[None, :] != i)
                  & (idx[None, :] <= last[i0:i0 + chunk, None])).sum()
    return int(total)


def _direct_collision_bound(x, alive, first, side):
    """x, y, alive read and the partners written once; for each pair the
    search needs (an alive particle's alive partners up to its first hit,
    or all of them), 2 f32 operations where the x image alone rules a hit
    out and 14 for the rest (``_direct_candidates``), none on the
    special-function unit. Returns the bound and the two pair counts."""
    upto = torch.cumsum(alive.long(), 0)
    idx = torch.arange(x.numel(), device=x.device)
    hit = first >= 0
    seen = torch.where(hit, upto[first.clamp(min=0).long()] - (idx < first)
                       .long(), upto[-1] - 1)
    pairs = float(seen[alive].sum())
    cand = _direct_candidates(x, alive, first, side)
    return (*_direct_bound(2 * (pairs - cand) + 14 * cand, 0,
                           x.numel() * (2 * x.element_size() + 1 + 4),
                           x.dtype), pairs, cand)


class _Clocks:
    """nvidia-smi's SM clock and power draw sampled every 50 ms while the
    block runs (a process of its own); ``summary()`` gives their medians."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out = self.proc.communicate()[0]
        rows = [line.split(",") for line in out.splitlines()
                if line.count(",") == 1]
        self.samples = [(float(a), float(b)) for a, b in rows
                        if a.strip() and b.strip()]

    def summary(self):
        if not self.samples:
            return "clocks not read"
        mhz = statistics.median(a for a, _ in self.samples)
        watts = statistics.median(b for _, b in self.samples)
        return (f"SM clock {mhz:.0f} MHz, {watts:.1f} W (medians of "
                f"{len(self.samples)} nvidia-smi samples)")


def _direct_sass(recs):
    """Print each direct kernel's inner-loop SASS instructions a pair
    (float32 build, ``cuobjdump -sass``) beside its bound, where the
    toolkit has cuobjdump."""
    from particlesimulation_tpu_torch.ops.cuda import (
        cell_pairs, direct_nbody, direct_sweep)

    hot = direct_sweep.sass_per_pair(cell_pairs.build(direct_nbody.SOURCE))
    if hot is None:
        print("direct kernels' SASS: no cuobjdump, not read", flush=True)
        return
    ops = {"direct_forces": "22 f32 operations a pair, an FMA as 2",
           "direct_collisions": "2 a pair ruled out on x, 14 a candidate"}
    for name, rec in recs.items():
        loop = hot.get(f"{name}_kernel<float>")
        if loop is None:
            raise AssertionError(f"{name}: no hot loop found in the SASS")
        print(f"{name}_kernel<float> SASS hot loop {loop['from']}-"
              f"{loop['to']}: {loop['path']} instructions on the common "
              f"path for {loop['pairs']} pairs, {loop['per_pair']:.3f} a "
              f"pair; kernel {rec['device_ms']:.4f} device ms, bound "
              f"{rec['bound_ms']:.4f} ms ({ops[name]})", flush=True)


def check_direct(card):
    """(al)-(aq) The direct model: both kernels against their plain versions
    on planted cases (N up to 8191, float32 and float64) and at N = 1e5
    past JAX's int32 rank wrap; DirectSimulation cuda against cpu and the
    JAX results; no host sync in the run loop; N = 1e5 timed; the
    threshold's two-particle plants. Returns the main path's launch counts
    and the two kernel records."""
    from types import SimpleNamespace

    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.initializer import init_particles_host
    from particlesimulation_tpu_torch.models.direct_nbody import (
        DirectSimulation, make_step, state_from_numpy)
    from particlesimulation_tpu_torch.ops.cuda import direct_nbody as dk
    from particlesimulation_tpu_torch.ops.cuda.adversarial import (
        plant_direct_cases)
    from particlesimulation_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    f32 = torch.float32

    # al. Planted cases against the plain versions, both types.
    plain_8191 = {}
    for n, side in DIRECT_CASES:
        for dtype in (f32, torch.float64):
            tag = f"direct kernels N={n} side {side} {dtype}"
            x, y, m, alive, planted = _direct_planted(n, side, n, dtype)
            ferr, ratio, pratio, _ = _check_direct_forces(
                dk.direct_forces(x, y, m, side),
                dk.direct_forces_ref(x, y, m, side), x, y, m, side, tag)
            died, count = _check_partners(
                dk.direct_collisions(x, y, alive, side),
                dk.direct_collisions_ref(x, y, alive, side), tag, planted)
            print(f"{tag}: max|df|={ferr:.3e} (err/tol at most {ratio:.3e};"
                  f" the plain version's {pratio:.3e}), partners equal, "
                  f"{died} deaths, count {count}", flush=True)
            if (n, side, dtype) == (8191, 100.0, f32):
                plain_8191 = {
                    "direct_forces": _timed(
                        lambda: dk.direct_forces_ref(x, y, m, side), 3),
                    "direct_collisions": _timed(
                        lambda: dk.direct_collisions_ref(x, y, alive, side),
                        3)}

    # am. N = 1e5 with pairs planted past the int32 rank wrap: one step's
    # kernels against the plain versions.
    seed, side, n = DIRECT_BIG
    xs, ys, vxs, vys, ms = (np.array(a) for a in init_particles_host(
        SimConfig(seed, side, 1, n)))
    alive = np.ones(n, bool)
    planted = [s for s in plant_direct_cases(xs, ys, vxs, vys, ms, alive,
                                             side, DIRECT_WRAP_PAIRS)
               if s not in (9, 10)]
    st = state_from_numpy({"x": xs, "y": ys, "vx": vxs, "vy": vys, "m": ms,
                           "alive": alive, "collisions": np.zeros((), int)},
                          "cuda")
    tag = f"direct N={n} (seed {seed}, side {side})"
    fargs = (st.x, st.y, st.m, side)
    ferr, ratio, pratio, mag = _check_direct_forces(
        dk.direct_forces(*fargs), dk.direct_forces_ref(*fargs), *fargs, tag)
    # The check's teeth: forces that lack the last tile's partners (N mod
    # kTile = 672 of them; a kernel that dropped its tail) must fail it.
    lo = n - n % _direct_consts()[0]
    tail = _tail_forces(*fargs, lo)
    tail_ratio = float((tail.abs() / _direct_force_tol(
        mag, st.x.dtype).clamp(min=1e-300)).max())
    if tail_ratio <= 1:
        raise AssertionError(f"{tag}: the force check would pass forces "
                             f"without partners [{lo}, {n}) (err/tol "
                             f"{tail_ratio:.3e})")
    out = make_step(side, n, "cuda")(st)
    cargs = (out.x, out.y, st.alive, side)
    first, cref = dk.direct_collisions(*cargs), dk.direct_collisions_ref(
        *cargs)
    died, count = _check_partners(first, cref, tag, planted)
    if (died != int((st.alive & ~out.alive).sum())
            or count != int(out.collisions)):
        raise AssertionError(f"{tag}: the step's deaths and count differ")
    print(f"{tag}: one step, max|df|={ferr:.3e} (err/tol at most "
          f"{ratio:.3e}, the plain version's {pratio:.3e}; without partners [{lo}, {n}) err/tol would reach "
          f"{tail_ratio:.3e}); partners equal with pairs planted at "
          f"{DIRECT_WRAP_PAIRS} (past 46 340): {died} deaths, count {count}",
          flush=True)
    cbound = _direct_collision_bound(out.x, st.alive, first, side)
    print(f"{tag}: the collision search needs {cbound[3]:.0f} pairs, "
          f"{cbound[4]} of them candidates (fl(dx²) < eps2)", flush=True)
    recs = {}
    for name, kernel, plain, bound in (
            ("direct_forces", lambda: dk.direct_forces(*fargs),
             lambda: dk.direct_forces_ref(*fargs),
             _direct_force_bound(st.x, st.m)),
            ("direct_collisions", lambda: dk.direct_collisions(*cargs),
             lambda: dk.direct_collisions_ref(*cargs), cbound)):
        recs[name] = {"max_abs_err": ferr if name == "direct_forces" else 0.0,
                      **_kernel_times(kernel, plain),
                      "bound_ms": bound[0], "bound_by": bound[1],
                      "sfu_ms": bound[2], "library_ms": None}
        _report(f"{name} at N={n} (plain at N=8191: "
                f"{plain_8191[name]:.4f} ms)", recs[name])
    _direct_sass(recs)

    # an. DirectSimulation cuda against cpu, two card runs, JAX's results.
    for cfg in (DIRECT_2048, DIRECT_2048_DENSE):
        seed2, side2, n2, steps, x0, y0, c0 = cfg
        runs = []
        for device in ("cuda", "cuda", "cpu"):
            sim = DirectSimulation(seed2, side2, n2, device=device)
            sim.run(steps)
            runs.append((sim.collisions, sim.state))
        (ca, a), (cb, b), (cc, c) = runs
        label = f"direct {seed2} {side2} {n2}, {steps} steps"
        if not all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in a._fields):
            raise AssertionError(f"{label}: two card runs differ")
        dpos = max(float((getattr(a, f).cpu() - getattr(c, f)).abs().max())
                   for f in ("x", "y"))
        if (ca != cc or not torch.equal(a.alive.cpu(), c.alive)
                or dpos > DIRECT_TOL * side2):
            raise AssertionError(f"{label}: cuda ({ca}) vs cpu ({cc}), "
                                 f"max|dpos|={dpos}, or the dead sets "
                                 f"differ")
        x, y = float(a.x[0]), float(a.y[0])
        if not (ca == c0 and abs(x - x0) < DIRECT_TOL * side2
                and abs(y - y0) < DIRECT_TOL * side2):
            raise AssertionError(f"{label}: ({x}, {y}, {ca}) against JAX's "
                                 f"({x0}, {y0}, {c0})")
        print(f"{label}: two card runs bit for bit equal; cuda vs cpu: "
              f"collisions {ca} = {cc}, dead sets equal, max|dpos|={dpos:.3e};"
              f" JAX's result ({x0}, {y0}, {c0}) held: ({x:.6f}, {y:.6f}, "
              f"{ca})", flush=True)

    # ao. No host sync in the run loop; one (the count) in run.
    sim = DirectSimulation(*DIRECT_2048[:3], device="cuda")
    check_no_sync("direct", sim.advance, sim.state)
    syncs = _syncs(SimpleNamespace(run=lambda s, k: sim.run(k)), None, 2)
    if syncs != 1:
        raise AssertionError(f"direct run: {syncs} host syncs, not 1")
    print("direct run: one host synchronisation (the count's readback)",
          flush=True)

    # ap. N = 1e5: the main path's run, then timed.
    sim = DirectSimulation(*DIRECT_BIG, device="cuda")
    sim.advance(sim.state, 1)
    torch.cuda.synchronize()
    dk.reset_launches()
    st = sim.run(10)
    torch.cuda.synchronize()
    launches = dict(dk.LAUNCHES)
    print(f"direct N={n} on cuda, 10 steps: particle 0 ({float(st.x[0]):.4f}"
          f", {float(st.y[0]):.4f}), collisions {sim.collisions}, launches "
          f"{launches}", flush=True)
    if not (bool(torch.isfinite(st.x).all() and torch.isfinite(st.y).all())
            and st.x.shape == (n,) and all(v == 10 for v in
                                           launches.values())):
        raise AssertionError("direct N=1e5: non-finite, misshapen, or a "
                             "kernel not launched every step")
    ms = profiling.bench_fn(sim.advance, sim.state, 10, warmup=1, iters=3,
                            device="cuda") / 10 * 1e3
    print(f"direct N={n}: {ms:.4f} ms/step, {2 * n * n / ms / 1e9:.4f} "
          f"T pair evaluations/s (two passes of N² a step) on {card}",
          flush=True)
    device_breakdown(f"direct N={n}", SimpleNamespace(run=sim.advance),
                     sim.state, ms)
    st = sim.state
    for dtype in (f32, torch.float64):
        x, y, m = (a.to(dtype) for a in (st.x, st.y, st.m))
        with _Clocks() as clocks:
            ev_f = device_ms(lambda: dk.direct_forces(x, y, m, side), 20)
            ev_c = device_ms(lambda: dk.direct_collisions(x, y, st.alive,
                                                          side), 20)
        print(f"direct N={n}: on the run's state in {dtype}, device ms "
              f"(CUDA events, median of 20): forces {ev_f:.4f}, collisions "
              f"{ev_c:.4f}; {clocks.summary()}", flush=True)

    # aq. The threshold's planted pairs, forces bit for bit.
    check_direct_threshold()
    print(f"direct phases: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, recs


def _around(v, k):
    """v and its k float neighbours on either side, in v's type."""
    f = type(v)
    out, lo, hi = [v], v, v
    for _ in range(k):
        lo, hi = np.nextafter(lo, f(-np.inf)), np.nextafter(hi, f(np.inf))
        out += [lo, hi]
    return out


def _threshold_cases(side, dtype):
    """Phase aq's two-particle cases, (a, b) on one axis: from a = 0 (in
    the box), b - a exactly the threshold T and its 2 float neighbours on
    either side, side/2 and its neighbours, the 3 floats below side, 0, a
    difference whose square is subnormal, EPSILON and its neighbours, and
    the collision window's edges; across the periodic edge, b = side -
    EPSILON and its neighbours; from a = -side/4 (out of the box) the same
    differences, and two of side or more (JAX's division)."""
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops.cuda.direct_nbody import (
        collision_window, min_image_threshold)

    f = np.float32 if dtype == torch.float32 else np.float64
    s, t = f(side), f(min_image_threshold(side, dtype))
    c, h = (f(v) for v in collision_window(side, dtype))
    below = [np.nextafter(s, f(0))]
    for _ in range(2):
        below.append(np.nextafter(below[-1], f(0)))
    tiny = f(2.0 ** -70) if f is np.float32 else f(2.0 ** -540)
    ds = (_around(t, 2) + _around(s / f(2), 1) + below
          + [f(0), tiny] + _around(f(EPSILON), 2)
          + _around(c - h, 1) + _around(c + h, 1))
    cases = [(f(0), d) for d in ds]
    cases += [(f(0), f(s - e)) for e in _around(f(EPSILON), 2)]
    a = f(-side / 4)
    cases += [(a, f(a + d)) for d in ds] + [(a, f(a + s)), (a, f(a + 1.25 * s))]
    return cases


def check_direct_threshold():
    """(aq) Two particles, in float32 and float64 at sides 1000, 1 and
    0.05, at each of ``_threshold_cases`` on x or on y, the other
    coordinate equal, EPSILON/2 apart or 0.4·side apart: the kernel's
    forces equal the plain version's bit for bit (one term each), and its
    partners the plain version's."""
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops.cuda import direct_nbody as dk

    count = hits = 0
    for dtype in (torch.float32, torch.float64):
        f = np.float32 if dtype == torch.float32 else np.float64
        bits = torch.int32 if dtype == torch.float32 else torch.int64
        m = torch.tensor([1.0, 3.0], dtype=dtype, device="cuda")
        alive = torch.ones(2, dtype=torch.bool, device="cuda")
        for side in (1000.0, 1.0, 0.05):
            others = [(f(0.3 * side), f(0.3 * side + d))
                      for d in (0.0, EPSILON / 2, 0.4 * side)]
            for a, b in _threshold_cases(side, dtype):
                for o in others:
                    for axis in (0, 1):
                        p = np.array([[a, b], o] if axis == 0
                                     else [o, [a, b]], f)
                        x, y = (torch.tensor(v, device="cuda") for v in p)
                        tag = (f"threshold plant {dtype} side {side} "
                               f"({a!r}, {b!r}) on axis {axis}, other "
                               f"{o}")
                        got = dk.direct_forces(x, y, m, side)
                        ref = dk.direct_forces_ref(x, y, m, side)
                        if not all(torch.equal(g.view(bits), r.view(bits))
                                   for g, r in zip(got, ref)):
                            raise AssertionError(
                                f"{tag}: forces {[g.tolist() for g in got]}"
                                f" against {[r.tolist() for r in ref]}")
                        first = dk.direct_collisions(x, y, alive, side)
                        cref = dk.direct_collisions_ref(x, y, alive, side)
                        if not torch.equal(first, cref):
                            raise AssertionError(
                                f"{tag}: partners {first.tolist()} against "
                                f"{cref.tolist()}")
                        count += 1
                        hits += int(cref[0] >= 0)
    print(f"direct threshold plants: {count} two-particle cases ({hits} "
          f"hits), forces bit for bit and partners equal to the plain "
          f"version's", flush=True)


# --- The advance phase (phases ar-au) --------------------------------------


def _bits_equal(a, b):
    """Whether two tensors hold the same values bit for bit (floats by their
    bit patterns: -0 and +0 differ, NaNs compare by payload)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _float_bits_equal(a, b):
    """Whether two float tensors hold the same bit patterns (in either
    width: -0 and +0 differ, NaNs compare by payload)."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype])))


def _max_diff(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


ADVANCE_FIELDS = ("x", "y", "vx", "vy", "m", "occ", "pid")


def _clone_tiles(ts):
    """The tiles and their counters in new tensors: the wrappers write
    theirs in place, so each call of a check or a timing gets its own
    copy."""
    return ts._replace(**{k: getattr(ts, k).clone() for k in (
        *ADVANCE_FIELDS, "collisions", "panics", "overflow")})


def _tile_phases(build, *args):
    """(prologue, advance, pair_pass, settle) of a tile run, as the
    engine's maker (``make_resident_run``, ``make_banded_run``) hands them
    to ``ops/resident.make_tile_run``: caught there while ``build`` runs
    (settle None where the checkout's engine has none: its advance phase
    sums the cells)."""
    from particlesimulation_tpu_torch.ops import resident as res

    got = {}
    orig = res.make_tile_run

    def spy(prologue, advance, pair_args, pair_pass, *rest, **kw):
        got.update(prologue=prologue, advance=advance, pair_pass=pair_pass,
                   settle=kw.get("settle"))
        return orig(prologue, advance, pair_args, pair_pass, *rest, **kw)

    res.make_tile_run = spy
    try:
        build(*args)
    finally:
        res.make_tile_run = orig
    return got


def _advance_inputs(phases, state):
    """What the first step's advance phase takes: the prologue's tiles (with
    counters of their own), the first pair pass's forces, and the extra
    arguments, (the settle pass's row sums,) where the engine settles after
    its pair pass, else ()."""
    ts = _clone_tiles(phases["prologue"](state))
    fxd, fyd, _, _ = phases["pair_pass"](ts, collide=False)
    if phases["settle"] is None:
        return ts, fxd, fyd, ()
    return ts, fxd, fyd, (phases["settle"](ts, None, None, None, True),)


def _settle_inputs(phases, state):
    """What the first step's settle pass takes: the tiles after its
    delivery, its pair pass's ft and count, and its undelivered count."""
    ts, fxd, fyd, extra = _advance_inputs(phases, state)
    ts, undelivered = phases["advance"](ts, fxd, fyd, *extra)[:2]
    _, _, count, ft = phases["pair_pass"](ts, collide=True)
    return ts, ft, count, undelivered


def check_advance_launches(label, phases, state, most=10):
    """The advance phase of a path must issue at most ``most`` kernel
    launches a step, by the profile and by the wrappers' own counts."""
    rec = advance_phase(label, phases, state)
    if not (rec["advance_launches"] <= most
            and rec["advance_wrapper_launches"] is not None
            and rec["advance_wrapper_launches"] <= most):
        raise AssertionError(f"{label}: the advance phase issues "
                             f"{rec['advance_launches']} launches by the "
                             f"profile, {rec['advance_wrapper_launches']} by "
                             f"the wrappers")
    return rec


def check_step(label, eng, state, most, exact, steps=10, tries=3):
    """(at) A tile path's whole step: its kernel launches a step by the
    profile and by the wrappers' counts, and its host synchronisations a
    step, each a run of ``steps`` less a run of 0, over ``steps``. Fails
    on a synchronisation, on more than ``most`` launches, and with
    ``exact``, unless the two counts agree (every launch a wrapper's). The
    profiler has been seen to hand a session's kernel records to the next
    one, so a profile that disagrees (with ``exact``, with the wrappers'
    count; else with itself: a count that is not a whole number a step)
    is taken again, up to ``tries`` times."""
    def counted(n):
        torch.cuda.synchronize()
        reset_launches()
        eng.run(state, n)
        torch.cuda.synchronize()
        return sum(ADVANCE_KERNELS_A_CALL.get(k, 1) * v
                   for k, v in read_launches().items())

    wrappers = (counted(steps) - counted(0)) / steps
    syncs = (_syncs(eng, state, steps) - _syncs(eng, state, 0)) / steps
    for _ in range(tries):
        rows, rows0 = _profile(eng, state, steps), _profile(eng, state, 0)
        profiled = (sum(n for _, n, _ in rows)
                    - sum(n for _, n, _ in rows0)) / steps
        print(f"{label}: the whole step issues {profiled:g} kernel launches "
              f"a step by the profile, {wrappers:g} by the wrappers' counts, "
              f"and {syncs:g} host synchronisations", flush=True)
        if profiled == (wrappers if exact else int(profiled)):
            break
    if syncs != 0 or profiled > most or (exact and profiled != wrappers):
        raise AssertionError(f"{label}: {profiled} launches (at most "
                             f"{most}), {wrappers} by the wrappers, {syncs} "
                             f"syncs a step")
    return profiled, wrappers


# Kernels one call of each ops/cuda/advance wrapper launches (the delivery:
# its count, stage and place passes), a parent checkout's too.
ADVANCE_KERNELS_A_CALL = {"cell_sums_rows": 1, "monopole_integrate": 1,
                          "deliver": 3, "pair_masks": 1, "settle_sums": 1,
                          "monopole_gathered": 1, "monopole_supercell": 1,
                          "pack": 3, "compact": 2}


def advance_phase(label, phases, state, reps=5):
    """The advance phase of a step alone (the first step's, after a warm-up
    call), a call over ``reps`` calls, each on its own copy of the first
    step's tiles (made before the profiled window): its device ms and
    kernel launches from torch.profiler, every kernel's count summed and
    not rounded, and the device ms of each wrapper's kernels (by name:
    cell_sums_rows (a parent checkout's), monopole_integrate, deliver_*);
    and, where the checkout has the advance kernels, the exact launches
    from their wrappers' counts over the same calls (None where it has
    not)."""
    try:
        from particlesimulation_tpu_torch.ops.cuda import advance as adv
    except ImportError:
        adv = None
    ts, fxd, fyd, extra = _advance_inputs(phases, state)
    tiles = [_clone_tiles(ts) for _ in range(reps + 1)]
    phases["advance"](tiles[0], fxd, fyd, *extra)
    if adv is not None:
        adv.reset_launches()

    def calls():
        for t in tiles[1:]:
            phases["advance"](t, fxd, fyd, *extra)

    rows = _profile_fn(calls)
    exact = None
    if adv is not None:
        exact = sum(ADVANCE_KERNELS_A_CALL[k] * n
                    for k, n in adv.LAUNCHES.items()) / reps
    launches = sum(n for _, n, _ in rows) / reps
    dev = sum(ms for ms, _, _ in rows) / reps
    parts = {f"{k}_device_ms": sum(ms for ms, _, key in rows
                                   if k in key) / reps
             for k in ("cell_sums_rows", "monopole_integrate", "deliver")}
    top = "; ".join(f"{k[:40]} {ms / reps:.4f} ({n / reps:g})"
                    for ms, n, k in sorted(rows, reverse=True)[:6])
    print(f"{label}: the advance phase issues {launches:g} kernel launches "
          f"by the profile, {exact} by the wrappers' counts, {dev:.4f} "
          f"device ms ("
          + ", ".join(f"{k[:-10]} {v:.4f}" for k, v in parts.items())
          + f"); by kernel (ms, launches): {top}", flush=True)
    return {"advance_launches": launches, "advance_wrapper_launches": exact,
            "advance_device_ms": dev, **parts}


def _cell_sums_bound(nslots, nrows):
    """(bound_ms, bound_by, sfu_ms) of a parent checkout's row sums: x, y,
    m (4 bytes) and occ (1) read a slot, the row starts read and M, SX, SY
    written a row, the limbo count; 7 f32 operations a slot (the cell's two
    divisions, two products, three sums)."""
    return _bound(13 * nslots + 20 * nrows + 12, 7 * nslots, 0)


def _masks_bound(nslots):
    """(bound_ms, bound_by, sfu_ms) of the pair pass's masks: x, y, m (4
    bytes) and occ (1) read and mf, alive (4) written a slot; 4 f32
    operations a slot (the cell's two divisions, m > 0, the select)."""
    return _bound(21 * nslots, 4 * nslots, 0)


def _settle_bound(nslots, nrows, deaths):
    """(bound_ms, bound_by, sfu_ms) of the settle pass: x, y, m, ft (4
    bytes) and occ (1) read a slot; the row starts read and M, SX, SY
    written a row; each death's m written (4); count and undelivered read
    and collisions (8), overflow and panics read and written (24); 7 f32
    operations a slot (the cell's two divisions, two products, three
    sums)."""
    return _bound(17 * nslots + 20 * nrows + 4 * deaths + 24, 7 * nslots, 0)


def _lane_order_sums(terms, row_start):
    """Each row's sum of the flat float32 ``terms`` in the settle kernel's
    order, in plain torch: lane l of the row's warp adds the row's slots l,
    l + 32, ... in turn from +0, then the lanes' sums meet in warp_fsum's
    butterfly (offsets 16, 8, 4, 2, 1). Each add is one rounded f32 add, as
    on the card; the +0 terms that pad a row to a multiple of 32 change no
    lane's sum (a lane's sum is never -0)."""
    from particlesimulation_tpu_torch.ops.cuda import advance as adv

    lane = torch.arange(32, device=terms.device)
    parts = []
    for s0, rows, w in adv._segments(row_start):
        chunks = (w + 31) // 32
        v = torch.nn.functional.pad(terms[s0:s0 + rows * w].view(rows, w),
                                    (0, 32 * chunks - w))
        v = v.view(rows, chunks, 32)
        acc = torch.zeros((rows, 32), dtype=terms.dtype, device=terms.device)
        for j in range(chunks):
            acc = acc + v[:, j]
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[:, lane ^ off]
        parts.append(acc[:, 0])
    return torch.cat(parts)


def _monopole_bound(nslots, nrows, live):
    """What the function needs: a live slot (m != 0; occupied under the
    engines' invariant that an empty slot has m 0) reads x, y, vx, vy, m,
    fxd, fyd (4 bytes) and occ, and writes x, y, vx, vy, dest (4) and
    moving (1), 50 bytes; any other slot is frozen, so only its x, y, m
    and occ are read and dest and moving written, 18 bytes; the rows' sums
    and starts read once. ~150 f32 operations and 8 rsqrt a live slot (8
    terms of 14, the integrator, two cells), 2 a frozen slot (its cell)."""
    frozen = nslots - live
    return _bound(50 * live + 18 * frozen + 20 * nrows,
                  150 * live + 2 * frozen, 8 * live)


def _monopole_copy_bound(nslots, nrows):
    """The copy-out floor of a design that reads and writes every
    slot's state: 50 bytes a slot, the rows' sums and starts read."""
    return _bound(50 * nslots + 20 * nrows, 0, 0)


def _deliver_bound(nslots, nrows, movers):
    """What the delivery needs: occ and moving (1 byte) read a slot; each
    mover's destination read (4), its x, y, vx, vy, m, pid (4 bytes) read
    and written to its new slot with that slot's occ (1), and its old slot's
    occ and m cleared (5): 58 bytes a mover; the row starts read."""
    return _bound(2 * nslots + 58 * movers + 8 * nrows, 0, 0)


def _new_tiles_bound(nslots, nrows, movers):
    """The floor of a design that writes new tiles: x, y, vx, vy, m,
    pid (4 bytes), occ and moving (1) read and the seven fields written a
    slot, each mover's destination read, the row starts read."""
    return _bound(51 * nslots + 4 * movers + 8 * nrows, 0, 0)


def _record(rec, bound):
    rec["bound_ms"], rec["bound_by"], rec["sfu_ms"] = bound
    return rec


def check_cell_sums_rows(tag, ts, rs, side, nc, timed=False):
    """A parent checkout's row sums kernel (``--advance-times``, where its
    advance phase sums the cells) against torch.sum on the card (the plain
    version)
    within (K·2⁻²⁴)·Σ|terms| a row, K the row's width; the limbo count
    exactly; against itself in a second run bit for bit. With ``timed``,
    the record: ms, device ms, plain ms and the three torch.sum calls'
    (library) ms on the same terms."""
    from particlesimulation_tpu_torch.ops import resident as res
    from particlesimulation_tpu_torch.ops.cuda import advance as adv

    args = (ts.x, ts.y, ts.m, ts.occ, rs, side, nc)
    got, limbo = adv.cell_sums_rows(*args)
    again, limbo2 = adv.cell_sums_rows(*args)
    ref, rlimbo = adv.cell_sums_rows_ref(*args)
    x, y, m, occ = (t.reshape(-1) for t in (ts.x, ts.y, ts.m, ts.occ))
    _, _, valid = res.cell_of(x, y, side, nc)
    mf = torch.where(occ & valid, m, 0.0)
    terms = (mf, mf * x, mf * y)
    row = adv._row_of(rs)
    nrows = rs.numel() - 1
    width = (rs[1:] - rs[:-1]).double()
    worst = 0.0
    for g, r, t in zip(got, ref, terms):
        mag = torch.zeros(nrows, dtype=torch.float64,
                          device=t.device).index_add_(0, row,
                                                      t.abs().double())
        err = (g.double() - r.double()).abs()
        tol = width * 2.0 ** -24 * mag
        if bool((err > tol).any()):
            raise AssertionError(f"{tag}: cell sums beyond (K 2^-24) sum|t| "
                                 f"in {int((err > tol).sum())} rows")
        ratio = err / torch.clamp(tol, min=1e-300)
        worst = max(worst, float(ratio.max()))
    if int(limbo) != int(rlimbo) or not (_bits_equal(got, again)
                                         and int(limbo2) == int(limbo)):
        raise AssertionError(f"{tag}: limbo {int(limbo)} vs {int(rlimbo)}, "
                             f"second run equal {_bits_equal(got, again)}")
    rec = {"max_abs_err": _max_diff(got, ref)}
    print(f"{tag}: cell_sums_rows on {nrows} rows, {x.numel()} slots: within "
          f"{worst:.3f} of the bound (K 2^-24 sum|t|) of torch.sum, "
          f"max|d|={rec['max_abs_err']:.3e}, limbo {int(limbo)} exact, "
          f"a second run bit for bit", flush=True)
    if timed:
        mf2, mx2, my2 = (t.view(ts.x.shape) for t in terms)

        def library():
            return (torch.sum(mf2, dim=1), torch.sum(mx2, dim=1),
                    torch.sum(my2, dim=1))

        rec.update(_kernel_times(lambda: adv.cell_sums_rows(*args),
                                 lambda: adv.cell_sums_rows_ref(*args)))
        rec["library_ms"] = _timed(library, 20)
        rec["library_device_ms"] = device_ms(library, 20)
        _record(rec, _cell_sums_bound(x.numel(), nrows))
    return got, rec


def check_pair_masks(tag, ts, side, nc, timed=False):
    """(as) The masks kernel against the plain version on the card, mf by
    its bits and alive, and against itself in a second run; then the same
    pool's slots from the second on (views off 16-byte alignment: the
    kernel's one-slot path). With ``timed``, the record and its bound (21
    bytes a slot)."""
    from particlesimulation_tpu_torch.ops.cuda import advance as adv

    args = (ts.x, ts.y, ts.m, ts.occ, side, nc)
    got, again, ref = (adv.pair_masks(*args), adv.pair_masks(*args),
                       adv.pair_masks_ref(*args))
    shifted = [t.reshape(-1)[1:] for t in args[:4]]
    off, off_ref = (adv.pair_masks(*shifted, side, nc),
                    adv.pair_masks_ref(*shifted, side, nc))
    for name, a, b in (("plain", got, ref), ("second run", got, again),
                       ("one slot in, plain", off, off_ref),
                       ("one slot in, whole pool",
                        off, [t.reshape(-1)[1:] for t in got])):
        if not all(_bits_equal(u, v) for u, v in zip(a, b)):
            raise AssertionError(f"{tag}: pair_masks differs from {name}")
    rec = {"max_abs_err": _max_diff(got[0], ref[0])}
    print(f"{tag}: pair_masks bit for bit the plain version (mf, alive) on "
          f"{ts.x.numel()} slots ({int(got[1].sum())} alive), also one slot "
          f"in (off 16-byte alignment), and a second run", flush=True)
    if timed:
        rec.update(_kernel_times(lambda: adv.pair_masks(*args),
                                 lambda: adv.pair_masks_ref(*args)))
        rec["library_ms"] = None
        _record(rec, _masks_bound(ts.x.numel()))
    return rec


def check_settle_sums(tag, ts, ft, count, undelivered, rs, side, nc, kcap,
                      timed=False):
    """(as) The settle kernel against the plain version on the card, each
    call on its own copy of the tiles and counters: after a run's first
    pass (no ft, count or undelivered), after a step, and after a run's
    last step (no sums): m and the collision, panic and overflow counters
    bit for bit, the sums bit for bit ``_lane_order_sums`` of the plain
    version's terms and within (K·2⁻²⁴)·Σ|terms| of its ``torch.sum``, and
    all of it again in a second run. With ``timed``, the record of a step's
    call, its bound and three torch.sum calls on the same terms (library).
    Returns the record."""
    from particlesimulation_tpu_torch.ops import resident as res
    from particlesimulation_tpu_torch.ops.cuda import advance as adv

    def fresh():
        return _clone_tiles(ts)

    modes = (("first pass", None, None, None, True),
             ("step", ft, count, undelivered, True),
             ("last step", ft, count, undelivered, False))
    width = (rs[1:] - rs[:-1]).double()
    row = adv._row_of(rs)
    nrows = rs.numel() - 1
    for name, *parts, with_sums in modes:
        got_ts, again_ts, ref_ts = fresh(), fresh(), fresh()
        call = (*parts, rs, side, nc, kcap, with_sums)
        got = adv.settle_sums(got_ts, *call)
        again = adv.settle_sums(again_ts, *call)
        ref = adv.settle_sums_ref(ref_ts, *call)
        fields = ("m", "collisions", "panics", "overflow")
        bad = [k for k in fields
               if not _bits_equal(getattr(got_ts, k), getattr(ref_ts, k))
               or not _bits_equal(getattr(got_ts, k), getattr(again_ts, k))]
        if bad:
            raise AssertionError(f"{tag}, {name}: settle_sums differs in "
                                 f"{bad} from the plain version or itself")
        if not with_sums:
            if got is not None:
                raise AssertionError(f"{tag}, {name}: sums without sums")
            continue
        x, y, m, occ = (t.reshape(-1) for t in (ref_ts.x, ref_ts.y, ref_ts.m,
                                                 ref_ts.occ))
        _, _, valid = res.cell_of(x, y, side, nc)
        mf = torch.where(occ & valid, m, 0.0)
        terms = (mf, mf * x, mf * y)
        lanes = torch.stack([_lane_order_sums(t, rs) for t in terms])
        if not (_bits_equal(got, lanes) and _bits_equal(got, again)):
            raise AssertionError(f"{tag}, {name}: sums not bit for bit the "
                                 f"lane order's or a second run's")
        worst = 0.0
        for g, r, t in zip(got, ref, terms):
            mag = torch.zeros(nrows, dtype=torch.float64,
                              device=t.device).index_add_(0, row,
                                                          t.abs().double())
            err = (g.double() - r.double()).abs()
            tol = width * 2.0 ** -24 * mag
            if bool((err > tol).any()):
                raise AssertionError(f"{tag}: sums beyond (K 2^-24) sum|t| "
                                     f"of torch.sum in "
                                     f"{int((err > tol).sum())} rows")
            worst = max(worst, float((err / torch.clamp(tol, min=1e-300))
                                     .max()))
        if name == "step":
            rec = {"max_abs_err": _max_diff(got, ref)}
            step_terms = terms
            limbo = int(ref_ts.panics) - int(ts.panics)
    deaths = 0 if ft is None else int((ft != 0x7FFFFFFF).sum())
    print(f"{tag}: settle_sums on {nrows} rows, {ts.x.numel()} slots "
          f"({deaths} deaths, {limbo} limbo): m and counters bit for bit the "
          f"plain version after a first pass, a step and a last step; the "
          f"sums bit for bit the lane order, within {worst:.3f} of the "
          f"bound (K 2^-24 sum|t|) of torch.sum; a second run bit for bit",
          flush=True)
    if timed:
        call = (ft, count, undelivered, rs, side, nc, kcap, True)
        rec.update(_kernel_times(lambda t: adv.settle_sums(t, *call),
                                 lambda t: adv.settle_sums_ref(t, *call),
                                 fresh))
        mf2, mx2, my2 = (t.view(ts.x.shape) for t in step_terms)

        def library():
            return (torch.sum(mf2, dim=1), torch.sum(mx2, dim=1),
                    torch.sum(my2, dim=1))

        rec["library_ms"] = _timed(library, 20)
        rec["library_device_ms"] = device_ms(library, 20)
        _record(rec, _settle_bound(ts.x.numel(), nrows, deaths))
    return rec


def check_monopole_integrate(tag, ts, fxd, fyd, sums, rs, side, nc,
                             timed=False):
    """(at) The kernel against the plain composition on the card from the
    same sums, every output bit for bit, each call on its own copy of x,
    y, vx, vy (the wrappers update them in place); with ``timed``, the
    record, its bound (what the function needs: 50 bytes a live slot, 18
    a frozen one) and the copy-out floor (50 bytes a slot) beside it."""
    from particlesimulation_tpu_torch.config import DELTAT
    from particlesimulation_tpu_torch.ops.cuda import advance as adv

    rest = (ts.m, ts.occ, fxd, fyd, sums, rs, side, nc, DELTAT)

    def fresh():
        return tuple(t.clone() for t in (ts.x, ts.y, ts.vx, ts.vy))

    def kernel(xyv):
        return adv.monopole_integrate(*xyv, *rest)

    def plain(xyv):
        return adv.monopole_integrate_ref(*xyv, *rest)

    got = kernel(fresh())
    ref = plain(fresh())
    names = ("x", "y", "vx", "vy", "dest", "moving")
    bad = [n for n, a, b in zip(names, got, ref) if not _bits_equal(a, b)]
    if bad:
        diff = {n: int((a != b).sum()) for n, a, b in zip(names, got, ref)
                if n in bad}
        raise AssertionError(f"{tag}: monopole_integrate differs from the "
                             f"plain composition in {diff} slots")
    rec = {"max_abs_err": max(_max_diff(a, b) for a, b in zip(got, ref))}
    live = int((ts.m != 0).sum())
    print(f"{tag}: monopole_integrate bit for bit the plain composition "
          f"(x, y, vx, vy, dest, moving) on {ts.x.numel()} slots ({live} "
          f"live), {int(got[5].sum())} movers", flush=True)
    if timed:
        nslots, nrows = ts.x.numel(), rs.numel() - 1
        rec.update(_kernel_times(kernel, plain, fresh))
        rec["library_ms"] = None
        _record(rec, _monopole_bound(nslots, nrows, live))
        rec["copy_out_bound_ms"] = _monopole_copy_bound(nslots, nrows)[0]
        print(f"{tag}: monopole_integrate {rec['device_ms']:.4f} device ms "
              f"against the function's bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}; {live} live slots of {nslots}) and the "
              f"copy-out floor {rec['copy_out_bound_ms']:.4f} ms", flush=True)
    return got, rec


def check_deliver(tag, ts, moving, dest, rs, at=None, timed=False):
    """(ar) The kernel against the plain deliver on the card: every field
    of every slot bit for bit, and undelivered; against itself in a second
    run; each call on its own copy of the tiles (the wrappers write them
    in place). With movers undelivered, the tiles passed must come back
    unchanged, bit for bit. Returns (movers, undelivered, out, record)."""
    from particlesimulation_tpu_torch.ops.cuda import advance as adv

    args = (moving, dest, rs, at)

    def fresh():
        return _clone_tiles(ts)

    def kernel(t):
        return adv.deliver(t, *args)

    def plain(t):
        return adv.deliver_ref(t, *args)

    inp = fresh()
    got, left = kernel(inp)
    again, left2 = kernel(fresh())
    ref, rleft = plain(fresh())
    bad = [k for k in ADVANCE_FIELDS
           if not _bits_equal(getattr(got, k), getattr(ref, k))]
    redo = [k for k in ADVANCE_FIELDS
            if not _bits_equal(getattr(got, k), getattr(again, k))]
    if bad or redo or not int(left) == int(rleft) == int(left2):
        raise AssertionError(f"{tag}: deliver differs from the plain "
                             f"version in {bad}, from itself in {redo}; "
                             f"undelivered {int(left)}, {int(left2)} vs "
                             f"{int(rleft)}")
    if int(left) and not all(
            _bits_equal(getattr(t, k), getattr(ts, k))
            for t in (inp, got) for k in ADVANCE_FIELDS):
        raise AssertionError(f"{tag}: {int(left)} undelivered, but the "
                             f"tiles changed")
    movers = int(moving.sum())
    print(f"{tag}: deliver bit for bit the plain version in every field "
          f"and slot ({ts.x.numel()} slots, {rs.numel() - 1} rows, "
          f"{movers} movers{'' if at is None else f' among {at.numel()} at= slots'}"
          f", undelivered {int(left)}"
          f"{', the tiles unchanged' if int(left) else ''}), and a second "
          f"run", flush=True)
    rec = {"max_abs_err": 0.0}
    if timed:
        nslots, nrows = ts.x.numel(), rs.numel() - 1
        rec.update(_kernel_times(kernel, plain, fresh))
        rec["library_ms"] = None
        _record(rec, _deliver_bound(nslots, nrows, movers))
        rec["copy_out_bound_ms"] = _new_tiles_bound(nslots, nrows, movers)[0]
        print(f"{tag}: deliver {rec['device_ms']:.4f} device ms against the "
              f"function's bound {rec['bound_ms']:.4f} ms and the new tiles' "
              f"floor {rec['copy_out_bound_ms']:.4f} ms", flush=True)
    return movers, int(left), got, rec


def _movers(ts, side, nc, rs):
    """Each slot's destination row and moving flag as rebin marks them."""
    from particlesimulation_tpu_torch.ops import resident as res
    from particlesimulation_tpu_torch.ops.cuda import advance as adv

    cx, cy, valid = res.cell_of(ts.x, ts.y, side, nc)
    dest = cy * nc + cx
    row = adv._row_of(rs).view(ts.x.shape)
    return ts.occ & valid & (dest != row), dest


def _cuda_tiles(fields):
    from particlesimulation_tpu_torch.ops import resident as res

    z = torch.zeros((), device="cuda")
    return res.TileState(
        **{k: torch.from_numpy(fields[k].copy()).cuda()
           for k in ADVANCE_FIELDS},
        collisions=z.long(), panics=z.int(), overflow=z.int())


def flagship_advance():
    """(ar-at on the main path) The kernels around the pair pass on the
    flagship's own tiles (golden s1's config: the resident engine's
    prologue and first pair pass, and its first settle where the checkout
    settles after its pair pass; the masks and the settle pass on the tiles
    after step 1's delivery and pair pass), each checked against its plain
    version and timed against its bound. Where the checkout's advance phase
    sums the cells (a parent checkout's), its row sums kernel stands in for
    the masks and the settle pass. Returns (records, the post-integrate
    tiles, the monopole pass's outputs, the row starts)."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine, make_resident_run

    s1 = SimConfig(*GOLDEN_S1[:4])
    eng = Engine(s1, device="cuda")
    state = eng.init_state()
    kcap = eng.kcap
    ph = _tile_phases(make_resident_run, s1, kcap)
    ts, fxd, fyd, extra = _advance_inputs(ph, state)
    rs = torch.arange(s1.ncells + 1, device="cuda") * kcap
    tag = f"flagship tiles ({s1.ncells}, {kcap})"
    recs = {}
    if extra:
        sums = extra[0]
    else:
        sums, recs["cell_sums_rows"] = check_cell_sums_rows(
            tag, ts, rs, s1.side, s1.ncside, timed=True)
    out, recs["monopole_integrate"] = check_monopole_integrate(
        tag, ts, fxd, fyd, sums, rs, s1.side, s1.ncside, timed=True)
    post = ts._replace(x=out[0], y=out[1], vx=out[2], vy=out[3])
    movers, _, _, recs["deliver"] = check_deliver(
        "flagship post-integrate tiles", post, out[5], out[4], rs,
        timed=True)
    if extra:
        t1, ft, count, undelivered = _settle_inputs(ph, state)
        tag = (f"flagship tiles ({s1.ncells}, {kcap}) after step 1's "
               f"delivery and pair pass")
        recs["pair_masks"] = check_pair_masks(tag, t1, s1.side, s1.ncside,
                                              timed=True)
        recs["settle_sums"] = check_settle_sums(
            tag, t1, ft, count, undelivered, rs, s1.side, s1.ncside, kcap,
            timed=True)
    print(f"flagship (N = {s1.n_particles}, kcap {kcap}): {movers} movers "
          f"a step (the first; {movers / s1.n_particles:.4%} of the "
          f"particles)", flush=True)
    for name, rec in recs.items():
        _report(f"{name} on the flagship's tiles", rec)
    lib = recs.get("settle_sums", recs.get("cell_sums_rows"))
    print(f"  torch.sum x 3 on the same terms (library): "
          f"{lib['library_ms']:.4f} ms a call, {lib['library_device_ms']:.4f}"
          f" device", flush=True)
    return recs, post, out, rs


def _cuda_counts(count, undelivered):
    return (torch.tensor(count, dtype=torch.int32, device="cuda"),
            torch.tensor(undelivered, dtype=torch.int32, device="cuda"))


def _monopole_cases(adversarial, k):
    """(at) ``monopole_integrate`` on ``adversarial.advance_case`` and
    ``wrap_case`` at K = k, from the settle pass's sums."""
    from particlesimulation_tpu_torch.ops.cuda import advance as adv

    for name, case in (
            ("advance_case", "edge cells, d2 = 0, frozen, the wrap"),
            ("wrap_case", "the wrap's edges: a = 2 side - ulp, 2 side, "
                          "side, +0, -ulp, below -side")):
        if name == "advance_case":
            fields, afx, afy, aside, anc = adversarial.advance_case(k, seed=k)
        else:
            fields, afx, afy, aside, anc = adversarial.wrap_case(k)
        ts = _cuda_tiles(fields)
        rs = torch.arange(anc * anc + 1, device="cuda") * k
        tag = f"{name} K={k} ({case})"
        sums = adv.settle_sums(_clone_tiles(ts), None, None, None, rs,
                               aside, anc, k)
        check_monopole_integrate(tag, ts, torch.from_numpy(afx).cuda(),
                                 torch.from_numpy(afy).cuda(), sums, rs,
                                 aside, anc)


def _deliver_cases(adversarial, k, note=""):
    """(ar) ``deliver`` on ``adversarial.deliver_cases`` at K = k: the full
    row's 2 movers stay undelivered, every other case's none."""
    for name, (fields, dside, dnc) in adversarial.deliver_cases(
            k, seed=k).items():
        ts = _cuda_tiles(fields)
        rs = torch.arange(dnc * dnc + 1, device="cuda") * k
        moving, dest = _movers(ts, dside, dnc, rs)
        _, left, _, _ = check_deliver(f"deliver_cases {name} K={k}{note}", ts,
                                      moving, dest, rs)
        if (name == "full") != (left == 2):
            raise AssertionError(f"{name} K={k}: undelivered {left}")


def _settle_cases(adversarial, k):
    """(as) ``pair_masks`` and ``settle_sums`` on ``adversarial.settle_case``
    at K = k: deaths planted among holes, dead and limbo slots; 3
    collisions and 1 undelivered mover (overflow to K + 1)."""
    fields, sft, sside, snc = adversarial.settle_case(k, seed=k)
    ts = _cuda_tiles(fields)
    rs = torch.arange(snc * snc + 1, device="cuda") * k
    tag = f"settle_case K={k} (deaths, holes, dead and limbo slots)"
    check_pair_masks(tag, ts, sside, snc)
    check_settle_sums(tag, ts, torch.from_numpy(sft).cuda(),
                      *_cuda_counts(3, 1), rs, sside, snc, k)


def check_advance(card):
    """(ar-at) The kernels around the pair pass against their plain
    versions on the card: on the flagship's own tiles (golden s1's config,
    the resident engine's prologue, first pair pass and first settle, and
    step 1's tiles after its delivery and pair pass), on UNEVEN's banded
    pool (13 bands, rows of 13 widths), on an at= subset, on the
    adversarial tiles of ``adversarial.deliver_cases``, ``advance_case``,
    ``wrap_case`` and ``settle_case`` at K = 32, 160 and 1024 (the delivery
    and the settle pass at K = 33 too); then each kernel timed on the
    flagship's tiles against its bound. Returns {kernel: record}."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine
    from particlesimulation_tpu_torch.ops.banded import (make_banded_run,
                                                         row_starts)
    from particlesimulation_tpu_torch.ops.cuda.launch_sweep import (
        UNEVEN_BANDS)

    t0 = time.perf_counter()
    adversarial = _adversarial_module()
    recs, post, out, rs = flagship_advance()
    rng = np.random.default_rng(14)
    at = torch.from_numpy(np.sort(rng.choice(post.x.numel(), 20_000,
                                             replace=False))).cuda()
    # int64 destinations, as the mesh halo transport gives them.
    check_deliver("flagship post-integrate tiles, at= 20 000 slots, int64 "
                  "dest", post, out[5].reshape(-1)[at],
                  out[4].reshape(-1)[at].long(), rs, at=at)

    un = SimConfig(*UNEVEN)
    eng_u = Engine(un, device="cuda")
    state_u = eng_u.init_state()
    if eng_u.impl != "banded" or eng_u._band_plan != UNEVEN_BANDS:
        raise AssertionError(f"UNEVEN census: {eng_u.impl}")
    ph = _tile_phases(make_banded_run, un, UNEVEN_BANDS)
    ts, fxd, fyd, (sums,) = _advance_inputs(ph, state_u)
    rs = row_starts(UNEVEN_BANDS, un.ncside, "cuda")
    widths = sorted({k for _, _, k in UNEVEN_BANDS})
    tag = f"UNEVEN banded pool ({len(UNEVEN_BANDS)} bands, widths {widths})"
    out, _ = check_monopole_integrate(tag, ts, fxd, fyd, sums, rs, un.side,
                                      un.ncside)
    check_deliver(tag + ", post-integrate", ts._replace(
        x=out[0], y=out[1], vx=out[2], vy=out[3]), out[5], out[4], rs)
    t1, ft, count, undelivered = _settle_inputs(ph, state_u)
    tag += ", after step 1's delivery and pair pass"
    check_pair_masks(tag, t1, un.side, un.ncside)
    check_settle_sums(tag, t1, ft, count, undelivered, rs, un.side,
                      un.ncside, max(widths))

    for k in (32, 160, 1024):
        _monopole_cases(adversarial, k)
        _deliver_cases(adversarial, k)
    # Rows of 33 slots: row starts off 4-byte alignment, so the delivery's
    # passes read the flags a byte at a time.
    _deliver_cases(adversarial, 33, " (rows off 4-byte alignment)")
    for k in (32, 33, 160, 1024):
        _settle_cases(adversarial, k)
    print(f"kernel phases around the pair pass (ar-at): "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
    return recs


# (label, config, impl asked for (None: the census), the engine the row
# must measure, steps timed).
ADVANCE_PATHS = (("flagship resident", GOLDEN_S1[:4], None, "resident", 100),
                 ("UNEVEN banded", UNEVEN, None, "banded", 10),
                 ("1e7 resident", (1, 5000.0, 316, 10_000_000), "resident",
                  "resident", 10),
                 ("1e7 banded", (1, 5000.0, 316, 10_000_000), None, "banded",
                  10))
# Steps of the run whose final state each checkout's digest covers.
ADVANCE_DIGEST_STEPS = 10


def advance_times(root):
    """(au) With the port package of the checkout at ``root``: for the
    flagship resident path, UNEVEN banded and N = 1e7 resident and banded,
    the whole step's ms/step, device ms/step, idle share, launches and
    syncs a step and its kernels' device ms/step, the advance phase's own
    launches and device ms (each wrapper's kernels apart; the phase is the
    checkout's own), and the digest of a run's final state
    (``ADVANCE_DIGEST_STEPS`` steps from the path's initial state); where
    the checkout has the advance kernels, each one's ms and device ms on
    the flagship's tiles against its bound, beside three torch.sum calls.
    Prints one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine, make_resident_run
    from particlesimulation_tpu_torch.ops.banded import make_banded_run

    try:
        from particlesimulation_tpu_torch.ops.cuda import advance as adv
    except ImportError:
        adv = None
    card = _card()
    out = {}
    for label, args, impl, want, k in ADVANCE_PATHS:
        cfg = SimConfig(*args)
        eng = Engine(cfg, device="cuda", impl=impl)
        state = eng.init_state()  # the census routes here
        eng.run(state, 1)
        ms, _, _ = step_ms(eng, state, k)
        rec = {"impl": eng.impl, "ms_per_step": ms}
        times = device_breakdown(f"{root}: {label}", eng, state, ms)
        if eng.impl != want:
            raise AssertionError(f"{root}: {label} ran {eng.impl}")
        rec.update(device_ms_per_step=times["device_ms"],
                   device_ms_whole=times["device_ms_whole"],
                   idle=times["idle"], launches=times["launches"],
                   syncs=times["syncs"], step_kernels=times["kernels"])
        if eng.impl == "banded":
            ph = _tile_phases(make_banded_run, cfg, eng._band_plan)
        else:
            ph = _tile_phases(make_resident_run, cfg, eng.kcap)
        rec.update(advance_phase(f"{root}: {label}", ph, state))
        final = eng.run(state, ADVANCE_DIGEST_STEPS)
        rec["digest"] = digest([getattr(final, f) for f in final._fields])
        print(f"{root}: {label}: the final state after "
              f"{ADVANCE_DIGEST_STEPS} steps ({int(final.collisions)} "
              f"collisions), digest {rec['digest'][:16]}", flush=True)
        out[label] = rec
        del eng, state, final
        torch.cuda.empty_cache()
    if adv is not None:
        with _Clocks() as clocks:
            recs = flagship_advance()[0]
        out["kernels"] = recs
        print(f"{root}: kernels timed at {clocks.summary()}", flush=True)
    print(f"advance times {root} on {card}", flush=True)
    print("ADVANCE_TIMES " + json.dumps(out), flush=True)


# The settle pass's rows (warps) a block swept (--settle-sweep).
SETTLE_WARPS = (1, 2, 4, 8, 16)


def settle_sweep():
    """(--settle-sweep) The settle pass on the tiles after step 1's delivery
    and pair pass of the flagship resident path, UNEVEN's banded pool and
    the 1e7 resident tiles, at each of ``SETTLE_WARPS`` rows a block, each
    call on its own copy of the tiles and counters: every launch shape's
    sums, m and counters bit for bit the wrapper's, and its device ms
    (median of 20). Prints a line a tile set."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine, make_resident_run
    from particlesimulation_tpu_torch.ops.banded import (make_banded_run,
                                                         row_starts)
    from particlesimulation_tpu_torch.ops.cuda import advance as adv

    rule = adv.SETTLE_WARPS
    for label, args, impl in (
            ("flagship resident", GOLDEN_S1[:4], "resident"),
            ("UNEVEN banded pool", UNEVEN, "banded"),
            ("1e7 resident", (1, 5000.0, 316, 10_000_000), "resident")):
        cfg = SimConfig(*args)
        eng = Engine(cfg, device="cuda", impl=impl)
        state = eng.init_state()
        if impl == "banded":
            ph = _tile_phases(make_banded_run, cfg, eng._band_plan)
            rs = row_starts(eng._band_plan, cfg.ncside, "cuda")
            kcap = max(k for _, _, k in eng._band_plan)
        else:
            ph = _tile_phases(make_resident_run, cfg, eng.kcap)
            rs = torch.arange(cfg.ncells + 1, device="cuda") * eng.kcap
            kcap = eng.kcap
        ts, ft, count, undelivered = _settle_inputs(ph, state)

        def settle(t):
            return adv.settle_sums(t, ft, count, undelivered, rs, cfg.side,
                                   cfg.ncside, kcap)

        def fresh():
            return _clone_tiles(ts)

        times = []
        try:
            ref_t = fresh()
            ref = settle(ref_t)
            for warps in SETTLE_WARPS:
                adv.SETTLE_WARPS = warps
                t = fresh()
                got = settle(t)
                same = _bits_equal(got, ref) and all(
                    _bits_equal(getattr(t, k), getattr(ref_t, k))
                    for k in ("m", "collisions", "panics", "overflow"))
                if not same:
                    raise AssertionError(f"{label}: settle at {warps} rows "
                                         f"a block differs from {rule}")
                times.append((warps, device_ms(settle, 20, fresh)))
        finally:
            adv.SETTLE_WARPS = rule
        print(f"{label} ({ts.x.numel()} slots, {rs.numel() - 1} rows): "
              f"settle_sums device ms by rows a block: "
              + ", ".join(f"{w} {ms:.4f}" for w, ms in times)
              + f"; the wrapper's {rule}; bound "
              f"{_settle_bound(ts.x.numel(), rs.numel() - 1, 0)[0]:.4f}",
              flush=True)
        del eng, state, ts, ft
        torch.cuda.empty_cache()


def check_advance_paths():
    """(--advance) Golden s1 through the resident engine and UNEVEN through
    the banded engine with the advance kernels: the known results, every
    kernel launched, no host sync, the advance phase's launches, the whole
    step's launches and syncs; cuda == cpu on a small config of each.
    Returns the two runs' launch counts, summed."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import Engine, make_resident_run
    from particlesimulation_tpu_torch.ops.banded import make_banded_run
    from particlesimulation_tpu_torch.ops.cuda.launch_sweep import (
        UNEVEN_BANDS)

    s1 = SimConfig(*GOLDEN_S1[:4])
    eng = Engine(s1, device="cuda")
    state = eng.init_state()
    _, res = check_golden("golden s1 resident", eng, state, GOLDEN_S1[4],
                          GOLDEN_S1[5:], ["fused_pairs", *ADVANCE_KERNELS])
    check_no_sync("resident", make_resident_run(s1, eng.kcap)[2], state)
    check_advance_launches("resident flagship", _tile_phases(
        make_resident_run, s1, eng.kcap), state)
    check_step("resident flagship", eng, state, 12, exact=True)
    un = SimConfig(*UNEVEN)
    eng = Engine(un, device="cuda")
    state = eng.init_state()
    _, band = check_golden("UNEVEN banded", eng, state, 2, UNEVEN_2,
                           ["fused_pairs", *ADVANCE_KERNELS])
    check_no_sync("banded", make_banded_run(un, UNEVEN_BANDS)[2], state)
    check_advance_launches("UNEVEN banded", _tile_phases(
        make_banded_run, un, UNEVEN_BANDS), state)
    check_step("UNEVEN banded", eng, state, 30, exact=False)
    check_gpu_vs_cpu(2, 100.0, 16, 12_000, 5)
    check_gpu_vs_cpu(-7, 100.0, 12, 4000, 10, impl="banded",
                     plan=((0, 3, 64), (3, 3, 256), (6, 3, 256), (9, 3, 64)))
    return {k: res[k] + band[k] for k in ADVANCE_KERNELS}


def times_of_all(roots, kind):
    """--advance-times, --sweep-times and --mesh-times (``kind`` "advance",
    "sweep" or "mesh"):
    each checkout in a process of its own (``--{kind}-times-of``), in
    turns; prints each path's whole step for every checkout and fails
    unless every run's final states have the same digests, path by path."""
    marker = f"{kind.upper()}_TIMES "
    runs = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               f"--{kind}-times-of", root], cwd=ROOT,
                              capture_output=True, text=True)
        print(proc.stdout, end="", flush=True)
        print(proc.stderr[-4000:], end="", file=sys.stderr, flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"--{kind}-times-of {root}: exit "
                             f"{proc.returncode}")
        line = next(l for l in proc.stdout.splitlines()
                    if l.startswith(marker))
        runs.append((root, json.loads(line[len(marker):])))
    paths = [label for label in runs[0][1] if label != "kernels"]
    for label in paths:
        for root, rec in runs:
            r = rec[label]
            top = "".join(f"; {k} {v:.4f}" for k, v in r.get("top", ()))
            top += "; the port's kernels: " + ", ".join(
                f"{k} {v:.4f}" for k, v in r.get("ours", {}).items())
            if "sorts" in r:
                top += (f"; sort launches {r['sorts']:g}, scan launches "
                        f"{r['scans']:g} a step")
            print(f"{label} | {root}: the whole step {r['ms_per_step']:.4f} "
                  f"ms/step, {r['device_ms_per_step']:.4f} device ms/step, "
                  f"idle {r['idle']:.1%}, {r['launches']:.1f} launches, "
                  f"{r['syncs']:.2f} syncs a step; digest "
                  f"{r['digest'][:16]}{top}", flush=True)
    if kind == "advance":
        _advance_summaries(runs, paths)
    first = runs[0][1]
    diff = [(root, label) for root, rec in runs[1:] for label in paths
            if rec[label]["digest"] != first[label]["digest"]]
    if diff:
        raise AssertionError(f"final states differ from {runs[0][0]}'s: "
                             f"{diff}")
    print(f"{kind} times: {len(runs)} runs ({', '.join(roots)}), every "
          f"path's final state bit for bit the same in all; on {_card()}",
          flush=True)


def _advance_summaries(runs, paths):
    """--advance-times: each checkout's advance phase by its own measure (a
    parent's sums the cells, the change's does not: its settle pass does,
    so the two are not set side by side) and its kernels on the
    flagship's tiles."""
    for root, rec in runs:
        for label in paths:
            r = rec[label]
            parts = ", ".join(
                f"{k} {r[f'{k}_device_ms']:.4f}"
                for k in ("cell_sums_rows", "monopole_integrate", "deliver")
                if r[f"{k}_device_ms"] > 0)
            print(f"{root} | {label}: its advance phase "
                  f"{r['advance_device_ms']:.4f} device ms, "
                  f"{r['advance_launches']:g} / "
                  f"{r['advance_wrapper_launches']} launches ({parts}); its "
                  f"step's own kernels (device ms/step): "
                  + ", ".join(f"{k} {v:.4f}"
                              for k, v in r["step_kernels"].items()),
                  flush=True)
    for root, rec in runs:
        kern = rec.get("kernels", {})
        print(f"kernels on the flagship's tiles | {root}: "
              + ", ".join(f"{k} {v['device_ms']:.4f} device ms (bound "
                          f"{v['bound_ms']:.4f}"
                          + (f", copy-out floor {v['copy_out_bound_ms']:.4f}"
                             if "copy_out_bound_ms" in v else "") + ")"
                          for k, v in kern.items()), flush=True)


# --- Tiles up to K = 4096 (phases av-ay) ------------------------------------

# The widths of phase av: a multiple of 32 just past the JAX Pallas cap
# (1024), the middle, and the kernels' MAX_KCAP.
WIDE_K = (1056, 2048, 4096)
# Rows of the timed K = 4096 tiles (one block an SM on an H100's 132) and
# their occupied slots a row (Poisson mean), S² labels a row for the
# labelled form and the cell sums.
WIDE_ROWS, WIDE_FILL, WIDE_LABELS = 132, 3000, 100
# The CPU tests' ncside-2 config (tests/test_torch_wide_tiles.py), 5 steps:
# resident at K = 1440 under dense_backend="xla".
WIDE_CARD_VS_CPU = (1, 10.0, 2, 5000, 5)


def check_wide_kernels(card):
    """(av) The kernels that take rows wider than 1024 slots against their
    plain versions on the card: at K = 1056, 2048 and 4096 on the
    adversarial tiles, the fused kernel in v4, v2 and v1 with collide on
    and off, both dense kernels (with and without pids), the labelled block
    form under every label layout with the cell sums on the same tiles;
    then each kernel at K = 4096 on WIDE_ROWS rows of flagship-like tiles
    (``_tiles``, WIDE_FILL slots full, WIDE_LABELS labels a row for the
    labelled form and the cell sums), checked and timed with its bound.
    Returns {kernel: record at K = 4096}."""
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs
    from particlesimulation_tpu_torch.ops.cuda.adversarial import (
        adversarial_tiles)

    t0 = time.perf_counter()
    for kcap in WIDE_K:
        check_adversarial(kcap)
        x, y, m, alive, pid = (torch.from_numpy(a).cuda()
                               for a in adversarial_tiles(kcap, kcap))
        for form in ("v4", "v2"):
            args = (x, y, m, alive, pid, kcap, EPSILON, False, form)
            got = cell_pairs.fused_pairs(*args)
            ref = cell_pairs.fused_pairs_ref(*args)
            tag = f"adversarial K={kcap} fused_pairs {form} collide=False"
            if int(got[2]) != 0 or not torch.equal(got[3], ref[3]):
                raise AssertionError(f"{tag}: collisions with collide off")
            err = _force_err(got[:2], ref[:2], _term_sums(x, y, m, form),
                             kcap, tag)
            print(f"{tag}: no collision, max|df|={err:.3e}", flush=True)
        check_adversarial_labelled(kcap)
    recs = {}
    kcap = WIDE_K[-1]
    where = f"({WIDE_ROWS}, {kcap})"
    tiles = _tiles(WIDE_ROWS, kcap, WIDE_FILL, kcap + WIDE_ROWS, "cuda")
    recs["fused_pairs"] = fused_record(where, tiles, "v4", True)
    recs["fused_pairs_v1"] = fused_record(where, tiles, "v2", True,
                                          gated=False)
    # Labels 0..WIDE_LABELS-1 on occupied slots, -1 on the others; each
    # planted chain (slots 0-2 of every 50th row) in one label.
    rng = np.random.default_rng(kcap)
    sub = torch.from_numpy(rng.integers(0, WIDE_LABELS, (WIDE_ROWS, kcap))
                           .astype(np.int32)).cuda()
    sub[:, :3] = 7
    sub = torch.where(tiles[2] > 0, sub, -1).contiguous()
    recs["fused_pairs_sub"] = fused_record(where, tiles, "v4", True, sub=sub)
    row = torch.arange(WIDE_ROWS, device="cuda")[:, None]
    cell = torch.where(sub >= 0, row * WIDE_LABELS + sub, -1).to(torch.int32)
    recs["supercell_cell_sums"] = check_cell_sums(
        f"K={kcap}, {WIDE_LABELS} cells a row", tiles, cell,
        WIDE_ROWS * WIDE_LABELS)
    recs["dense_pairwise_forces"] = check_dense_forces(WIDE_ROWS, kcap,
                                                       WIDE_FILL)
    recs["dense_collisions"] = check_dense_collisions(WIDE_ROWS, kcap,
                                                      WIDE_FILL, False)
    check_dense_collisions(WIDE_ROWS, kcap, WIDE_FILL, True)
    print(f"wide-tile kernel phase (av): {time.perf_counter() - t0:.1f} s on "
          f"{card}", flush=True)
    return recs


def check_advance_wide(card):
    """(aw) The kernels around the pair pass on rows of K = 4096 against
    their plain versions on the card, bit for bit as in (ar)-(at): the
    delivery on ``adversarial.deliver_cases``, the monopole pass on
    ``advance_case`` and ``wrap_case``, the masks and the settle pass on
    ``settle_case``."""
    t0 = time.perf_counter()
    adversarial = _adversarial_module()
    k = WIDE_K[-1]
    _monopole_cases(adversarial, k)
    _deliver_cases(adversarial, k)
    _settle_cases(adversarial, k)
    print(f"kernels around the pair pass at K = {k} (aw): "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)


def check_medium_tiles(card, sweep):
    """(ax) MEDIUM (golden s3's config) under ``dense_backend="xla"``:
    resident tiles at K > 1024 with overflow 0, the fused kernel and the
    kernels around it launched, two runs bit for bit equal, no host sync;
    particle 0 and the count printed beside golden s3's f64 values and the
    f32 sweep's ``sweep`` (not held, as in (e)); the step's ms, device ms,
    idle share, launches and syncs; the fused kernel on the run's own tiles
    and both dense kernels on the dense engine's MEDIUM tiles (checked,
    timed, with the bound); cuda == cpu on WIDE_CARD_VS_CPU. Returns the
    path's launch counts and its measures."""
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import (Engine, make_dense_step,
                                                     make_resident_run)
    from particlesimulation_tpu_torch.ops.cuda.launch_sweep import (
        dense_tiles, resident_tiles)

    t0 = time.perf_counter()
    seed, side, nc, n, steps = MEDIUM
    cfg = SimConfig(seed, side, nc, n)
    eng = Engine(cfg, device="cuda", dense_backend="xla")
    state = eng.init_state()
    out, (x, y, c), launches = drive(
        "MEDIUM, dense_backend=xla", eng, state, steps,
        ["fused_pairs", *ADVANCE_KERNELS])
    again = eng.run(state, steps)
    fields = ("x", "y", "vx", "vy", "m", "alive", "pid", "collisions")
    same = all(torch.equal(getattr(out, f), getattr(again, f))
               for f in fields)
    swept = ("not run" if sweep is None else
             f"({sweep[0]:.4f}, {sweep[1]:.4f}, {sweep[2]})")
    print(f"MEDIUM on {eng.impl} tiles at kcap {eng.kcap}: particle 0 "
          f"({x:.4f}, {y:.4f}), {c} collisions after {steps} steps; golden "
          f"s3 (f64) {GOLDEN_S3}, the f32 sweep {swept} (not held); two "
          f"runs bitwise equal: {same}", flush=True)
    if eng.impl != "resident" or eng.kcap <= 1024 or not same:
        raise AssertionError("MEDIUM under dense_backend='xla'")
    check_no_sync("MEDIUM resident", make_resident_run(cfg, eng.kcap)[2],
                  state)
    ms, t1, tk = step_ms(eng, state, steps)
    print(f"MEDIUM resident, kcap {eng.kcap}: {ms:.4f} ms/step, "
          f"{n / ms / 1e3:.2f} M particle-steps/s (run(1) {t1:.4f} s, "
          f"run({steps + 1}) {tk:.4f} s) on {card}", flush=True)
    times = {"ms": ms, **device_breakdown("MEDIUM resident", eng, state, ms)}
    times["fused_pairs"] = fused_record(
        "MEDIUM resident tiles", resident_tiles(cfg, eng.kcap, state, steps),
        "v4", True, planted=False)
    eng_d = Engine(cfg, device="cuda", impl="dense", dense_backend="xla")
    state_d = eng_d.init_state()
    check_tiles("MEDIUM dense", [dense_tiles(
        cfg, make_dense_step(cfg, eng_d.kcap)[1](state_d))])
    check_gpu_vs_cpu(*WIDE_CARD_VS_CPU, dense_backend="xla")
    print(f"MEDIUM on tiles (ax): {time.perf_counter() - t0:.1f} s on "
          f"{card}", flush=True)
    return launches, times


def check_medium_mesh(card):
    """(ay) MEDIUM through the CLI's ``--mesh 4 --engine fast``
    in-process: a tile route (the fused kernel launched; the mesh sweep
    launches none), its lines printed (not held); then the mesh engine the
    CLI builds (the census: resident tiles at K > 1024), timed. Returns the
    CLI's launch counts and the measures."""
    from particlesimulation_tpu_torch import cli
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine

    t0 = time.perf_counter()
    seed, side, nc, n, steps = MEDIUM
    args = [str(seed), f"{side:g}", str(nc), str(n), str(steps), "--engine",
            "fast", "--mesh", "4"]
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    torch.cuda.synchronize()
    launches = read_launches()
    lines = out.getvalue().splitlines()
    print(f"CLI {' '.join(args)} in-process on cuda: rc {rc}, {lines}, "
          f"{err.getvalue().strip()} on stderr, launches {launches} (golden "
          f"s3, f64: {GOLDEN_S3}; not held)", flush=True)
    if not (rc == 0 and len(lines) == 2 and launches["fused_pairs"] > 0
            and all(np.isfinite(float(v)) for v in lines[0].split())):
        raise AssertionError("MEDIUM --mesh 4 --engine fast")
    eng = ShardedEngine(SimConfig(seed, side, nc, n, n_shards=4),
                        device="cuda")
    state = eng.init_state()
    if eng.impl != "resident" or eng.kcap <= 1024:
        raise AssertionError(f"MEDIUM mesh: {eng.impl}, kcap {eng.kcap}")
    times = _mesh_times("MEDIUM mesh D=4", eng, state, card)
    print(f"MEDIUM mesh (ay): {time.perf_counter() - t0:.1f} s on {card}",
          flush=True)
    return launches, times


def check_wide(card, sweep):
    """Phases av-ay. Returns the kernels' records at K = 4096 and the
    launch counts of MEDIUM's one-device tile run."""
    recs = check_wide_kernels(card)
    check_advance_wide(card)
    launches, _ = check_medium_tiles(card, sweep)
    check_medium_mesh(card)
    return recs, launches


# -- the sweep's kernels (phases az-bb) ---------------------------------------

# The reference's heavy golden vectors (tests/test_golden.py:33-44) that
# phase ba runs through the default CLI (parity on cuda), and the four
# long-horizon ones that --golden-long runs.
HEAVY_GOLDEN = (
    (1, 5000, 100, 1_000_000, 100, 3899.787, 156.291, 163),
    (1, 5000, 20, 1_000_000, 10, 3918.912, 143.364, 19),
    (3, 5000, 50, 1_000_000, 300, 3819.032, 25.659, 469),
    (-11, 3500, 20, 500_000, 10, 1984.878, 1625.992, 35),
    (-50, 10000, 200, 500_000, 10, 5025.384, 5303.928, 4),
)
LONG_GOLDEN = (
    (1, 1000, 3, 10_000, 10_000, 287.788, 261.446, 31),
    (12, 100, 5, 10_000, 10_000, 76.732, 61.943, 2209),
    (3, 5000, 50, 1_000_000, 500, 3738.436, 58.743, 804),
    (-1, 1000, 30, 100_000, 1000, 575.878, 370.663, 1203),
)
# Launch counts of the sweep kernels on each path that ran them, by label
# (the kernels line sums them).
SWEEP_LAUNCHES = {}


def reset_sweep_launches():
    from particlesimulation_tpu_torch.ops.cuda import sweep

    sweep.reset_launches()
    for mod in (_migrate_launches(), _stencil_module()):
        if mod is not None:
            mod.reset_launches()


def read_sweep_launches(label=None):
    """The sweep kernels' launch counts, the migration pack's (a mesh's
    sweep) and the stencil tables'; with ``label``, recorded for the
    kernels line and the sweep's required non-zero (each path of the sweep
    runs all four, and the one-device or the mesh tables' kernels)."""
    from particlesimulation_tpu_torch.ops.cuda import sweep

    got = dict(sweep.LAUNCHES)
    for mod in (_migrate_launches(), _stencil_module()):
        if mod is not None:
            got.update(mod.LAUNCHES)
    if label is not None:
        need = list(SWEEP_KERNELS)
        if _stencil_module() is not None:
            need += (STENCIL_MESH if got["stencil_halo"] or got.get("compact")
                     else ("stencil_grid",))
        if not all(got.get(k, 0) > 0 for k in need):
            raise AssertionError(f"{label}: a sweep kernel did not launch: "
                                 f"{got}")
        SWEEP_LAUNCHES[label] = got
    return got


def _sweep_lanes(x, y, side, nc):
    """The sweep step's lanes of sorted positions: key, pos, occupancy (its
    host part read back, for the plain versions)."""
    from particlesimulation_tpu_torch.ops import binning

    key, _ = binning.cell_keys(x, y, side, nc)
    pos, _ = binning.segment_positions(key)
    return key, pos, binning.occupancy(key, nc * nc, pos).read()


def _alive_pairs(key, alive, ncells):
    """(unordered same-cell pairs of alive lanes, alive lanes in cells, the
    lanes in cells): the work the pair passes' functions need."""
    real = key < ncells
    a = torch.zeros(ncells + 1, dtype=torch.float64, device=key.device)
    a.index_add_(0, key.long(), (alive & real).double())
    return (float((a * (a - 1) / 2).sum()), float(a.sum()),
            int(real.sum()))


def _sweep_candidates(x, key, alive, ncells):
    """The unordered pairs of alive lanes in one cell whose x alone has
    fl(dx²) < 4·EPSILON² (dx in the lanes' type): the pairs the collision
    function must test. In (key, x) order a lane's candidates follow it
    within its cell, and if no pair lies an offset d apart none lies
    further."""
    from particlesimulation_tpu_torch.config import EPSILON

    live = (key < ncells) & alive
    k, xs = key[live].long(), x[live]
    order = torch.argsort(xs, stable=True)
    order = order[torch.argsort(k[order], stable=True)]
    k, xs = k[order], xs[order]
    eps = torch.full((), EPSILON, dtype=x.dtype, device=x.device)
    far2 = 4 * eps * eps
    total, d = 0, 1
    while d < k.numel():
        dx = xs[d:] - xs[:-d]
        near = int(((k[d:] == k[:-d]) & (dx * dx < far2)).sum())
        if near == 0:
            break
        total, d = total + near, d + 1
    return total


def _sweep_bounds(key, alive, plan, ncells, x):
    """({kernel: (bound_ms, bound_by)}, alive pairs, the collision
    function's candidates, the collisions' all-pairs bound_ms): each
    input of the JAX function read once, each output written once: the COM
    the sorted keys (4 B a lane), x, y, m and 3 values a cell out; the
    forces the keys, x, y, m, alive, the (8, ncells + 1) tables and fx, fy
    out; the collisions the keys, the positions in cell (int32 in JAX, 4 B
    a lane), x, y, alive, the dead mask and the count out. The lanes' int64
    ``pos`` and the per-key counts are this interface's choice, not the
    functions' need, and are not counted there; the occupancy kernel's
    function is the counts: its keys and pos read, the counts written. The
    operations the function needs
    on these lanes: the COM 9 a lane (parity: two divisions, four products,
    three sums; fast: two products, three sums a lane, two divisions a
    cell); the forces 17 an unordered pair of alive lanes in one cell (their
    term once, added to both ends; parity's division and square root
    counted as one operation each) and 17 a monopole term of an alive lane,
    8 a lane; the collision test 6 a candidate pair (``_sweep_candidates``;
    hits are rare, and the square root only near EPSILON). float64 at 34
    TFLOP/s, float32 at 67."""
    n = key.shape[0]
    dtype = x.dtype
    s = 8 if dtype == torch.float64 else 4
    peak = PEAK_F64 if dtype == torch.float64 else PEAK_F32
    pairs, alive_lanes, lanes = _alive_pairs(key, alive, ncells)
    cand = _sweep_candidates(x, key, alive, ncells)
    coll_bytes = n * (4 + 4 + 2 * s + 2) + 8
    work = {
        "sweep_com": (n * (4 + 3 * s) + 3 * s * ncells, 9 * lanes),
        "sweep_forces": (n * (4 + 5 * s + 1) + 3 * 8 * (ncells + 1) * s,
                         17 * pairs + 17 * 8 * alive_lanes),
        "sweep_collisions": (coll_bytes, 6 * cand),
        # each lane's key and pos read, each key's count written (the
        # occupancy's own interface: the function is the counts)
        "sweep_occupancy": (n * (4 + 8) + 8 * (ncells + 1), 0),
    }
    out = {}
    for k, (nbytes, ops) in work.items():
        mem, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
        out[k] = (max(mem, ops_ms), "bytes" if mem >= ops_ms else
                  "operations")
    all_pairs = max(coll_bytes / PEAK_BYTES, 6 * pairs / peak) * 1e3
    return out, pairs, cand, all_pairs


def _position_order_com(x, y, m, key, pos, plan, ncells):
    """The fast COM with each cell's sums in position order (the kernel's
    order, and its parent's), as plain torch: position p's lanes added to
    their cells' sums, one lane a cell in each call, then the quotients."""
    real = key < ncells
    p = torch.where(real, pos, torch.full_like(pos, plan.host_kmax))
    order = torch.argsort(p, stable=True)
    per = torch.bincount(p, minlength=plan.host_kmax + 1).tolist()
    k = key.long()
    sums = torch.zeros((3, ncells), dtype=x.dtype, device=x.device)
    terms = torch.stack([m, m * x, m * y])
    start = 0
    for c in per[:plan.host_kmax]:
        idx = order[start:start + c]
        sums.index_add_(1, k[idx], terms[:, idx])
        start += c
    M, SX, SY = sums
    has = M > 0
    safe = torch.where(has, M, torch.ones_like(M))
    zero = torch.zeros_like(M)
    return (M, torch.where(has, SX / safe, zero),
            torch.where(has, SY / safe, zero))


def _check_com(tag, lanes_, x, y, m, ncells):
    """The COM kernel against its plain version on one set of lanes: parity
    bit for bit; fast bit for bit against the sums in position order
    (``_position_order_com``) and, where finite, within c·2⁻²⁴·Σ|terms| of
    the plain version (which sums (ncells, kmax) rows with torch.sum); a
    second run bit for bit. Returns (the kernel call, the plain call, the
    kernel's (M, MX, MY), max |err| against the plain version, whether it
    equals the plain version bit for bit)."""
    from particlesimulation_tpu_torch.ops.cuda import sweep

    key, pos, plan = lanes_
    parity = x.dtype == torch.float64

    def com_k():
        return sweep.sweep_com(x, y, m, key, pos, plan, ncells)

    def com_p():
        return sweep.sweep_com_ref(x, y, m, key, pos, plan, ncells)

    ck, cp = com_k(), com_p()
    err = max(_max_diff(a, b) for a, b in zip(ck, cp))
    bits = all(_float_bits_equal(a, b) for a, b in zip(ck, cp))
    if parity and not bits:
        diff = [torch.nonzero(a.view(torch.int64) != b.view(torch.int64))
                .flatten()[:4].tolist() for a, b in zip(ck, cp)]
        raise AssertionError(
            f"{tag}: parity COM not bit for bit; first cells differing "
            f"(M, MX, MY): {diff}; kernel "
            f"{[a[d].tolist() for a, d in zip(ck, diff)]}, plain "
            f"{[b[d].tolist() for b, d in zip(cp, diff)]}")
    if not parity:
        order = _position_order_com(x, y, m, key, pos, plan, ncells)
        if not all(_float_bits_equal(a, b) for a, b in zip(ck, order)):
            raise AssertionError(f"{tag}: f32 COM differs from the sums in "
                                 f"position order")
        # Each cell's c sums in another order: |d Σ| <= c·u·Σ|terms|, and
        # the quotients' relative error twice that plus an ulp.
        u = 2.0 ** -24
        kc = torch.clamp(key.long(), max=ncells)

        def cell_sums(v):
            return torch.zeros(ncells + 1, dtype=torch.float64,
                               device=x.device).index_add_(0, kc, v)[:ncells]

        c = cell_sums(torch.ones_like(x, dtype=torch.float64))
        M = cell_sums(m.double())
        tol_m = c * u * M + u * M
        bad = (ck[0].double() - cp[0].double()).abs() > tol_m
        for q, v in ((1, x), (2, y)):
            S = cell_sums((m * v.abs()).double())
            tol = (2 * c * u + 2 * u) * S / torch.where(M > 0, M, 1.0) + (
                u * cp[q].double().abs())
            bad |= (ck[q].double() - cp[q].double()).abs() > tol
        if bool(bad.any()):
            raise AssertionError(f"{tag}: f32 COM outside c·2^-24·Σ|terms| "
                                 f"in {int(bad.sum())} cells")
    if not all(_float_bits_equal(a, b) for a, b in zip(com_k(), ck)):
        raise AssertionError(f"{tag}: a second COM run differs")
    return com_k, com_p, ck, err, bits


def _check_sweep_outputs(tag, lanes_, x, y, m, alive, side, nc,
                         com_only=False):
    """(az) The three kernels (with ``com_only`` the COM alone) against
    their plain versions on the card on one set of lanes; returns the
    kernel calls (for timing) and the max abs errors."""
    from particlesimulation_tpu_torch.config import EPSILON
    from particlesimulation_tpu_torch.ops import stencil
    from particlesimulation_tpu_torch.ops.cuda import sweep

    key, pos, plan = lanes_
    ncells = nc * nc
    com_k, com_p, ck, com_err, com_bits = _check_com(tag, lanes_, x, y, m,
                                                      ncells)
    if com_only:
        print(f"{tag}: {key.shape[0]} lanes, kmax {plan.host_kmax}: COM "
              f"bitwise "
              f"{com_bits} (max |err| {com_err:.3e}; f32: the position-order "
              f"sums' bits), a second run bit for bit", flush=True)
        return {"sweep_com": (com_k, com_p)}, {"sweep_com": com_err}
    tables = stencil.stencil_tables(*ck, side, nc)
    occ_k, occ_p = check_occupancy(tag, key, pos, ncells)

    def forces_k():
        return sweep.sweep_forces(x, y, m, alive, key, pos, plan, tables,
                                  ncells)

    def forces_p():
        return sweep.sweep_forces_ref(x, y, m, alive, key, pos, plan,
                                      tables, ncells)

    def coll_k():
        return sweep.sweep_collisions(x, y, alive, key, pos, plan, EPSILON,
                                      ncells)

    def coll_p():
        return sweep.sweep_collisions_ref(x, y, alive, key, pos, plan,
                                          EPSILON, ncells)

    fk, fp = forces_k(), forces_p()
    (nk, dk), (np_, dp) = coll_k(), coll_p()
    errs = {"sweep_com": com_err,
            "sweep_forces": max(_max_diff(a, b) for a, b in zip(fk, fp)),
            "sweep_collisions": float(int(nk) != int(np_)),
            "sweep_occupancy": 0.0}
    force_bits = all(_bits_equal(a, b) for a, b in zip(fk, fp))
    if int(nk) != int(np_) or not torch.equal(dk, dp):
        raise AssertionError(f"{tag}: collisions {int(nk)} vs {int(np_)}, "
                             f"dead sets equal {torch.equal(dk, dp)}")
    if not force_bits:
        raise AssertionError(f"{tag}: forces bitwise {force_bits}")
    # A second run, bit for bit.
    again = [*forces_k(), *coll_k()]
    first = [*fk, nk, dk]
    if not all(_bits_equal(a, b) for a, b in zip(again, first)):
        raise AssertionError(f"{tag}: a second run differs")
    print(f"{tag}: {key.shape[0]} lanes, kmax {plan.host_kmax}, "
          f"{int(nk)} collisions, {int(dk.sum())} deaths: COM bitwise "
          f"{com_bits} (max |err| {errs['sweep_com']:.3e}; f32: the "
          f"position-order sums' bits), forces bitwise "
          f"{force_bits} (max |err| {errs['sweep_forces']:.3e}), "
          f"count and dead set exact, a second run bit for bit", flush=True)
    return {"sweep_com": (com_k, com_p), "sweep_forces": (forces_k, forces_p),
            "sweep_collisions": (coll_k, coll_p),
            "sweep_occupancy": (occ_k, occ_p)}, errs


def check_occupancy(tag, key, pos, ncells):
    """(az) The occupancy kernel against its plain version on one set of
    lanes, field for field: each key's count (the sentinels' last), kmax,
    the large cells; a second run the same. Returns the kernel call and the
    plain call (for timing)."""
    from particlesimulation_tpu_torch.ops.cuda import sweep

    def occ_k():
        return sweep.sweep_occupancy(key, pos, ncells)

    def occ_p():
        return sweep.sweep_occupancy_ref(key, pos, ncells)

    got, want = occ_k(), occ_p()
    bad = [f for f, a, b in zip(("counts", "kmax", "large"), got, want)
           if not torch.equal(a, b)]
    if bad or not all(torch.equal(a, b) for a, b in zip(occ_k(), got)):
        raise AssertionError(f"{tag}: occupancy {bad} differ from the plain "
                             f"version (or a second run)")
    print(f"{tag}: occupancy kernel = plain field for field (kmax "
          f"{int(got[1])}, {int(got[2])} cells of more than "
          f"{sweep.SMALL_CELL} lanes, {int(got[0][-1])} sentinel lanes)",
          flush=True)
    return occ_k, occ_p


def _occupancy_library(key, ncells):
    """``index_add_`` of ones onto the keys' counts and ``amax`` of the
    real cells': the PyTorch calls the occupancy kernel replaces (timed
    only; the port never calls them)."""
    k = torch.clamp(key.long(), max=ncells)
    ones = torch.ones_like(k)
    counts = torch.zeros(ncells + 1, dtype=torch.int64, device=key.device)

    def lib():
        counts.zero_().index_add_(0, k, ones)
        return torch.amax(counts[:ncells])
    return lib


# The PyTorch calls timed beside a sweep kernel (library_ms).
LIBRARY_CALLS = {"sweep_com": "index_add_",
                 "sweep_occupancy": "index_add_ + amax"}


def _com_library(x, y, m, key, ncells):
    """``index_add_`` of (m, m·x, m·y) onto the cells: one PyTorch call for
    the fast COM's sums (timed only; the port never calls it)."""
    src = torch.stack([m, m * x, m * y])
    k = key.long()
    out = torch.zeros((3, ncells + 1), dtype=x.dtype, device=x.device)
    return lambda: out.index_add_(1, k, src)


def _sweep_state(args, parity, steps=0):
    """An engine's sorted sweep state on the card (after ``steps`` steps)."""
    from particlesimulation_tpu_torch.config import Precision, SimConfig
    from particlesimulation_tpu_torch.engine import Engine

    prec = Precision.PARITY if parity else Precision.FAST
    eng = Engine(SimConfig(*args[:4], precision=prec), impl="sweep",
                 device="cuda")
    state = eng.init_state()
    return eng.run(state, steps) if steps else state


def _sorted_lanes(xs, ys, ms, al, dtype, side, nc):
    """NumPy particles as sorted sweep lanes on the CPU: x, y, m, alive,
    key, pos."""
    from particlesimulation_tpu_torch.ops import binning

    x, y, m = (torch.from_numpy(a).to(dtype) for a in (xs, ys, ms))
    key, _ = binning.cell_keys(x, y, side, nc)
    key, _, x, y, m, alive = binning.sort_by_cell(
        key, torch.arange(x.shape[0], dtype=torch.int32), x, y, m,
        torch.from_numpy(al))
    pos, _ = binning.segment_positions(key)
    return x, y, m, alive, key, pos


def _layouts(lanes, ncells, layouts=("sorted", "mesh")):
    """(layout, lanes on the card in that layout, occupancy) for each of
    ``layouts``: sorted, or the mesh's (``adversarial.mesh_lane_order``)."""
    from particlesimulation_tpu_torch.ops import binning
    from particlesimulation_tpu_torch.ops.cuda import adversarial as adv

    key = lanes[4]
    for layout in layouts:
        perm = (torch.from_numpy(adv.mesh_lane_order(key.numpy(), ncells))
                if layout == "mesh" else torch.arange(key.shape[0]))
        out = [t[perm].contiguous().cuda() for t in lanes]
        yield layout, out, binning.occupancy(out[4], ncells, out[5]).read()


def check_com_case():
    """(az) The COM kernel on ``adversarial.com_particles`` (cells opening
    with massless runs, one past a round; cells of a round of the kernel's
    staging and a round plus one; masses from 2^-1074 to 2^1023, on both
    sides of the parity division's range edges; 7680 one-lane cells between
    empty ones), both precisions, sorted and in the mesh's layout."""
    from particlesimulation_tpu_torch.ops.cuda import adversarial as adv

    side, nc = adv.COM_SIDE, adv.COM_NCSIDE
    for dtype in (torch.float64, torch.float32):
        lanes = _sorted_lanes(*adv.com_particles(), dtype, side, nc)
        for layout, (x, y, m, _, key, pos), plan in _layouts(lanes, nc * nc):
            _check_sweep_outputs(f"COM kernel, adversarial COM case {dtype} "
                                 f"{layout}", (key, pos, plan), x, y, m,
                                 None, side, nc, com_only=True)


# (label, u's binary exponents, v's (each a tuple of ranges), pairs,
# midpoint, all-ones divisors)
_EDGES = ((-512, -508), (508, 512))
DIV_CHECK = (("random, exponents -540..540", ((-540, 540),), ((-540, 540),),
              4_000_000, False, False),
             ("all-ones divisors", ((-520, 520),), ((-520, 520),),
              1_000_000, False, True),
             ("quotients next to a midpoint", ((-240, 240),), ((-240, 240),),
              4_000_000, True, False),
             ("next to a midpoint, all-ones divisors", ((-240, 240),),
              ((-240, 240),), 1_000_000, True, True),
             ("operands at the range's edges", _EDGES, _EDGES, 2_000_000,
              False, False),
             ("quotients at the range's ends (2^-1024 .. 2^1024)",
              ((-512, -505),), ((505, 512),), 1_000_000, False, False),
             ("numerators +0 and -0", ((0, 0),), ((-520, 520),), 200_000,
              False, False))


def check_com_division():
    """(az) The parity COM's division (the reciprocal, then two fma
    corrections where the divisor lies in its range and the numerator too
    or is +0, else __ddiv_rn; ``sweep.div_check``) against __ddiv_rn on
    1.32e7 operand pairs made on the card (``DIV_CHECK``: random mantissas,
    u of either sign; the ends' pairs half of them swapped, so quotients
    reach both ends): the quotients' bits must all agree. Returns the
    mismatches and the pairs that took the reciprocal."""
    from particlesimulation_tpu_torch.ops.cuda import sweep

    gen = torch.Generator(device="cuda").manual_seed(20)
    dev, f64 = "cuda", torch.float64

    def operand(k, spans, ones):
        exps = torch.cat([torch.arange(lo, hi + 1) for lo, hi in spans]).to(
            device=dev, dtype=f64)
        e = exps[torch.randint(0, exps.shape[0], (k,), device=dev,
                               generator=gen)]
        mant = (torch.full((k,), 2 - 2.0 ** -52, dtype=f64, device=dev)
                if ones else
                1 + torch.rand(k, dtype=f64, device=dev, generator=gen))
        return torch.ldexp(mant, e)

    total, fast = 0, 0
    for label, eu, ev, k, midpoint, ones in DIV_CHECK:
        u = operand(k, eu, False) * torch.where(
            torch.rand(k, device=dev, generator=gen) < 0.5, -1.0, 1.0).to(f64)
        v = operand(k, ev, ones)
        if "ends" in label:
            h = k // 2
            u[h:], v[h:] = v[h:].clone(), u[h:].abs()
        if "+0" in label:
            u = u * 0
        bad, rcp = sweep.div_check(u, v, midpoint).tolist()
        print(f"COM division vs __ddiv_rn, {label}: {k} pairs, {bad} "
              f"mismatches, {rcp} through the reciprocal", flush=True)
        total, fast = total + bad, fast + rcp
    print(f"COM division vs __ddiv_rn: {sum(c[3] for c in DIV_CHECK)} "
          f"pairs, {total} mismatches, {fast} through the reciprocal",
          flush=True)
    if total or not fast:
        raise AssertionError(f"COM division: {total} mismatches, {fast} "
                             f"through the reciprocal")
    return total, fast


def com_chain_lane_ms(dtype, steps=1 << 16):
    """One lane's dependent latency on the COM kernel's chain, in ms: one
    thread walking ``steps`` lanes (``sweep.com_chain``), CUDA events,
    median of 5 launches over ``steps``."""
    from particlesimulation_tpu_torch.ops.cuda import sweep

    out = torch.zeros(3, dtype=dtype, device="cuda")
    sweep.com_chain(out, steps)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sweep.com_chain(out, steps)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"COM chain yardstick: {out.tolist()}")
    return statistics.median(times) / steps


SWEEP_STATES = (("parity s1", GOLDEN_S1, True),
                ("f32 sweep s1", GOLDEN_S1, False),
                ("MEDIUM f32", MEDIUM, False),
                ("MEDIUM f64", MEDIUM, True))


def check_sweep_kernels(card, com_only=False):
    """(az) The sweep's three kernels (with ``com_only`` the COM alone)
    against their plain versions on the card: the sorted states of parity
    s1, the f32 sweep at s1 and MEDIUM (f32 and f64), each also after one
    step, and the adversarial lanes of ``adversarial.sweep_particles``
    (sorted, and in the mesh's layout; the 10 000-lane cell of "huge", more
    than the kernels stage at once, sorted) in both precisions; the COM
    also on ``adversarial.com_particles`` (``check_com_case``) and its
    parity division against __ddiv_rn (``check_com_division``); each kernel
    timed at parity s1, the f32 sweep at s1 and MEDIUM in f32 and f64
    against its bound and its plain version, the COM also against its chain
    floor (the longest cell's lanes times one lane's latency on its chain,
    ``com_chain_lane_ms``). Returns {kernel: record} at parity s1 (the
    CLI's default path)."""
    from particlesimulation_tpu_torch.ops.cuda import adversarial as adv

    t0 = time.perf_counter()
    check_com_division()
    check_com_case()
    lane_ms = {dt: com_chain_lane_ms(dt)
               for dt in (torch.float64, torch.float32)}
    print("COM chain, one lane's latency: "
          + ", ".join(f"{dt} {ms * 1e6:.2f} ns" for dt, ms in lane_ms.items())
          + f" on {card}", flush=True)
    side, nc = adv.SWEEP_SIDE, adv.SWEEP_NCSIDE
    for case in ("planted", "hot", "wide", "huge"):
        for dtype in (torch.float64, torch.float32):
            lanes = _sorted_lanes(*adv.sweep_particles(case), dtype, side, nc)
            layouts = ("sorted", "mesh")[:1 if case == "huge" else 2]
            for layout, (x, y, m, al, key, pos), plan in _layouts(
                    lanes, nc * nc, layouts):
                _check_sweep_outputs(
                    f"sweep kernels, adversarial {case} {dtype} {layout}",
                    (key, pos, plan), x, y, m, al, side, nc, com_only)
    recs, times = None, {}
    kernels = ("sweep_com",) if com_only else SWEEP_KERNELS
    for label, args, parity in SWEEP_STATES:
        side, nc = float(args[1]), args[2]
        for steps in (0, 1):
            st = _sweep_state(args, parity, steps)
            lanes_ = _sweep_lanes(st.x, st.y, side, nc)
            calls, errs = _check_sweep_outputs(
                f"sweep kernels, {label} after {steps} steps", lanes_, st.x,
                st.y, st.m, st.alive, side, nc, com_only)
        key, pos, plan = lanes_
        bounds, pairs, cand, all_pairs = _sweep_bounds(
            key, st.alive, plan, nc * nc, st.x)
        out = {}
        for k in kernels:
            kern, plain = calls[k]
            rec = _kernel_times(kern, plain)
            rec.update(max_abs_err=errs[k], bound_ms=bounds[k][0],
                       bound_by=bounds[k][1], library_ms=None)
            if k == "sweep_com":
                rec["chain_floor_ms"] = (plan.host_kmax
                                         * lane_ms[st.x.dtype])
                if not parity:
                    lib = _com_library(st.x, st.y, st.m, key, nc * nc)
                    rec["library_ms"] = _timed(lib, 20)
                    rec["library_device_ms"] = device_ms(lib, 20)
            if k == "sweep_collisions":
                rec.update(candidates=cand, all_pairs_bound_ms=all_pairs)
            if k == "sweep_occupancy":
                lib = _occupancy_library(key, nc * nc)
                rec["library_ms"] = _timed(lib, 20)
                rec["library_device_ms"] = device_ms(lib, 20)
            out[k] = rec
            print(f"{label} {k}: {rec['ms']:.4f} ms a call, "
                  f"{rec['device_ms']:.4f} device ms, bound "
                  f"{rec['bound_ms']:.4f} ({rec['bound_by']}; "
                  f"{pairs:.4g} alive pairs), plain {rec['plain_ms']:.4f} "
                  f"ms" + (f", {LIBRARY_CALLS[k]} {rec['library_ms']:.4f} ms "
                           f"a call "
                           f"({rec['library_device_ms']:.4f} device)"
                           if rec["library_ms"] is not None else "")
                  + (f"; chain floor {rec['chain_floor_ms']:.4f} ms "
                     f"({plan.host_kmax} lanes), the kernel "
                     f"{rec['device_ms'] / rec['chain_floor_ms']:.2f}x it"
                     if k == "sweep_com" else "")
                  + (f"; {cand} candidate pairs, all-pairs bound "
                     f"{all_pairs:.4f}" if k == "sweep_collisions" else "")
                  + f" on {card}", flush=True)
        times[label] = out
        recs = recs or out
    print(f"sweep kernel phase (az): {time.perf_counter() - t0:.1f} s; "
          f"SWEEP_KERNEL_TIMES {json.dumps(times)}", flush=True)
    return recs


def check_cli_parity_inprocess():
    """(a) The CLI's default (parity on cuda) on golden s1 in-process, with
    the launch counts set to 0 just before: golden s1's lines exactly, the
    three sweep kernels launched. Returns the launch counts."""
    from particlesimulation_tpu_torch import cli

    seed, side, nc, n, steps, ex, ey, ec = GOLDEN_S1
    args = [str(seed), str(int(side)), str(nc), str(n), str(steps)]
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    reset_sweep_launches()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    torch.cuda.synchronize()
    launches = read_sweep_launches("CLI parity s1 (in-process)")
    lines = out.getvalue().splitlines()
    print(f"CLI {' '.join(args)} (parity, cuda) in-process: rc {rc}, "
          f"{lines}, launches {launches}", flush=True)
    if rc != 0 or lines != [f"{ex:.3f} {ey:.3f}", str(ec)]:
        raise AssertionError("CLI parity in-process")
    return launches


def run_golden(vectors, required):
    """(ba) The reference's golden vectors through the default CLI (parity
    on cuda), a process each: with ``required``, each must print its two
    lines exactly; else (--golden-long) each result is printed whatever it
    is. Returns [(vector, lines, seconds)]."""
    out = []
    for seed, side, nc, n, steps, ex, ey, ec in vectors:
        args = [str(seed), str(side), str(nc), str(n), str(steps)]
        want = [f"{ex:.3f} {ey:.3f}", str(ec)]
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            "particlesimulation_tpu_torch", *args], cwd=ROOT,
                           capture_output=True, text=True, timeout=1800)
        sec = time.perf_counter() - t
        lines = r.stdout.splitlines()
        timing = (r.stderr.strip().splitlines() or [""])[-1]
        ok = r.returncode == 0 and lines == want
        print(f"golden {' '.join(args)} through the CLI (parity, cuda): "
              f"{lines} (golden {want}) {'MATCH' if ok else 'DIFFERS'}; "
              f"{timing} on stderr, {sec:.1f} s with the process start",
              flush=True)
        if required and not ok:
            raise AssertionError(f"golden {args}: rc {r.returncode}, "
                                 f"{lines}, stderr {r.stderr[-2000:]}")
        out.append((args, lines, sec))
    return out


# --sweep-times: (label, config, parity, impl asked for (None: the
# census), steps profiled (a run of one more less a run of 1)); each
# path's ms/step over SWEEP_TIMED steps (a graphed run's host time
# overlaps its device time, so a few steps do not time it).
SWEEP_TIMED = 20
SWEEP_PATHS = (("parity s1", GOLDEN_S1[:4], True, None, 2),
               ("f32 sweep s1", GOLDEN_S1[:4], False, "sweep", 2),
               ("MEDIUM default", MEDIUM[:4], False, None, 1),
               ("MEDIUM parity", MEDIUM[:4], True, None, 1),
               ("parity 9 cells", LONG_GOLDEN[0][:4], True, None, 2))


def sweep_times(root):
    """(bb) With the port package of the checkout at ``root``, each path of
    ``SWEEP_PATHS`` (MEDIUM by the default census: the sweep under
    dense_backend="pallas"): ms/step (step_ms over SWEEP_TIMED steps, best
    of 2),
    device ms/step, idle share, launches and syncs a step (0 required of
    this checkout), and the digest of each run's final state after 4
    steps. Prints one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    from particlesimulation_tpu_torch.config import Precision, SimConfig
    from particlesimulation_tpu_torch.engine import Engine

    card = _card()
    out = {}
    for label, args, parity, impl, steps in SWEEP_PATHS:
        prec = Precision.PARITY if parity else Precision.FAST
        eng = Engine(SimConfig(*args, precision=prec), impl=impl,
                     device="cuda")
        state = eng.init_state()
        final = eng.run(state, 4)
        if eng.impl != "sweep":
            raise AssertionError(f"{root}: {label} ran {eng.impl}")
        ms, t1, tk = step_ms(eng, state, SWEEP_TIMED)
        t = steady_breakdown(f"{root}: {label}", eng, state, ms, steps + 1)
        if os.path.samefile(root, ROOT) and t["syncs"] != 0:
            raise AssertionError(f"{label}: {t['syncs']} host syncs a step")
        out[label] = {"ms_per_step": ms, "device_ms_per_step": t["device_ms"],
                      "idle": t["idle"], "launches": t["launches"],
                      "syncs": t["syncs"], "step_kernels": t["kernels"],
                      "digest": digest([getattr(final, f)
                                        for f in final._fields])}
        print(f"{root}: {label}: {ms:.4f} ms/step (run(1) {t1:.4f} s, "
              f"run({SWEEP_TIMED + 1}) {tk:.4f} s), final digest "
              f"{out[label]['digest'][:16]}", flush=True)
        del eng, state, final
        torch.cuda.empty_cache()
    print(f"sweep times {root} on {card}", flush=True)
    print("SWEEP_TIMES " + json.dumps(out), flush=True)


def check_sweep(card):
    """(az, ba) The sweep kernels against their plain versions and timed,
    then the heavy golden vectors through the default CLI. Returns the
    kernels' records."""
    recs = check_sweep_kernels(card)
    t = time.perf_counter()
    run_golden(HEAVY_GOLDEN, required=True)
    print(f"golden phase (ba): {time.perf_counter() - t:.1f} s", flush=True)
    return recs


def sweep_entries(recs):
    """The sweep kernels' records in the kernels line, their launches summed
    over the sweep paths this run drove (SWEEP_LAUNCHES)."""
    return [kernel_entry(k, sum(v[k] for v in SWEEP_LAUNCHES.values()),
                         recs[k], SWEEP_SOURCE) for k in SWEEP_KERNELS]


def build_libraries():
    """Build the six kernel libraries from the checkout's sources, one
    nvcc each, started together; print each one's -Xptxas -v report."""
    from concurrent.futures import ThreadPoolExecutor

    from particlesimulation_tpu_torch.ops.cuda import (advance, cell_pairs,
                                                       direct_nbody, migrate,
                                                       stencil, sweep)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(6) as pool:
        libs = list(pool.map(lambda f: f(), (
            cell_pairs.build, advance.build, sweep.build, migrate.build,
            stencil.build, lambda: cell_pairs.build(direct_nbody.SOURCE))))
    for lib in libs:
        print(f"built {lib} ({time.perf_counter() - t0:.2f} s for the six)",
              flush=True)
        with open(f"{lib}.log") as f:
            print(f.read().strip(), flush=True)


def kernel_entry(name, launches, rec, source=SOURCE):
    """A kernel's record in the ``kernels`` line (the delivery and the
    monopole pass also carry ``copy_out_bound_ms``, the floor of their
    first designs, beside the function's own bound; the COM
    ``chain_floor_ms``, its longest cell's lanes times one lane's latency
    on its chain)."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"),
            **{k: rec[k] for k in ("copy_out_bound_ms", "chain_floor_ms")
               if k in rec}}


def _card():
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def direct_times(root):
    """The direct model at N = 1e5 (DIRECT_BIG) with the port package of
    the checkout at ``root``: both kernels' device ms on the state after
    one step (CUDA events, median of 20) and ms/step over 10 steps
    (``bench_fn``, median of 3). Prints one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    from particlesimulation_tpu_torch.models.direct_nbody import (
        DirectSimulation)
    from particlesimulation_tpu_torch.ops.cuda import direct_nbody as dk
    from particlesimulation_tpu_torch.utils import profiling

    card = _card()
    seed, side, n = DIRECT_BIG
    sim = DirectSimulation(seed, side, n, device="cuda")
    st = sim.advance(sim.state, 1)
    torch.cuda.synchronize()
    with _Clocks() as clocks:
        times = {
            "forces_device_ms": device_ms(
                lambda: dk.direct_forces(st.x, st.y, st.m, side), 20),
            "collisions_device_ms": device_ms(
                lambda: dk.direct_collisions(st.x, st.y, st.alive, side),
                20),
            "ms_per_step": profiling.bench_fn(sim.advance, st, 10, warmup=1,
                                              iters=3, device="cuda") * 100}
    print(f"direct times {root} on {card}: {json.dumps(times)}; "
          f"{clocks.summary()}", flush=True)


# The adversarial labelled tiles' widths in --supercell-times: the warp
# kernel's one and two slots a lane, and the block kernel's.
SUPERCELL_TIMES_K = (32, 64, 160, 1024)


def digest(tensors):
    """SHA-256 (hex) of ``tensors``' dtypes, shapes and bytes, in order:
    equal for two lists exactly when every value has the same bits (-0 and
    +0 differ, as do two NaNs of other payloads)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        h.update(f"{t.dtype} {tuple(t.shape)};".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@functools.lru_cache(maxsize=None)
def _own_module(name):
    """This checkout's ``ops/cuda/<name>.py``, loaded from its file: the
    --supercell-times and --advance-times runs put another checkout's
    package first on the path, and this keeps their tiles and measures the
    same for every checkout."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"psim_own_{name}", os.path.join(
            ROOT, "particlesimulation_tpu_torch", "ops", "cuda",
            f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _adversarial_module():
    """This checkout's ``ops/cuda/adversarial.py``: every checkout timed by
    --supercell-times gets the same tiles."""
    return _own_module("adversarial")


def _measures():
    """This checkout's ``ops/cuda/launch_sweep.py``: its ``device_ms`` and
    ``fresh_inputs`` time every checkout of --advance-times alike."""
    return _own_module("launch_sweep")


def _labelled_bound(tiles, sub, m_post, form, collide):
    """(bound_ms, bound_by, sfu_ms) of the labelled pass: mf read and fx,
    fy, ft and the label for every slot, alive and pid too with collide on;
    x and y for the alive or used slots; the pair work over the pairs of
    equal labels (sum c^2 over the cells)."""
    x, _, m, alive, _ = tiles
    p_force, _ = _pairs(m_post > 0, sub)
    n_xy = float((((alive > 0) & collide) | (m > 0)).sum())
    return _bound(((24 if collide else 16) + 4) * x.numel() + 8 * n_xy + 4,
                  (15 if form == "v4" else 14) * p_force, p_force)


def supercell_times(root):
    """The supercell engine's two kernels with the port package of the
    checkout at ``root`` (which only its public wrappers reach), on SMALL's
    own pair-pass tiles (seed 50 from the
    host initializer, the census's supercell prologue, the engine's
    pair_tiles after SMALL's 10 steps) and on the adversarial tiles with
    each label layout at SUPERCELL_TIMES_K: each kernel's output digests,
    ms and device ms against the bound, the K = 32, 64 and 1024 all-label-0
    tiles' device ms, and SMALL's ms/step and device ms/step. Prints one
    JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    from particlesimulation_tpu_torch.config import EPSILON, SimConfig
    from particlesimulation_tpu_torch.engine import Engine
    from particlesimulation_tpu_torch.ops.cuda import cell_pairs
    from particlesimulation_tpu_torch.ops.supercell import make_supercell_run

    adv = _adversarial_module()
    card = _card()
    seed, side, nc, n, steps = SMALL
    cfg = SimConfig(seed, side, nc, n)
    eng = Engine(cfg, device="cuda")
    state = eng.init_state()
    tiles = make_supercell_run(cfg, eng.kcap,
                               eng._supercell_factor())[1](state, steps)
    *five, sub = tiles
    kinds = (("v4", True), ("v4", False), ("v2", True))

    def labelled(t5, lab, form, collide):
        return cell_pairs.fused_pairs(*t5, t5[0].shape[1], EPSILON,
                                      collide=collide, force_form=form,
                                      sub=lab)

    def sums_args(t5, cell, ncells):
        x, y, m = t5[:3]
        return (m, m * x, m * y, cell, ncells)

    out = {"digests": {"SMALL tiles (inputs)": digest(tiles)}}
    small_cells = true_cells(five, sub, cfg)
    out["digests"]["SMALL labelled"] = digest(
        [t for kind in kinds for t in labelled(five, sub, *kind)])
    out["digests"]["SMALL cell sums"] = digest(cell_pairs.supercell_cell_sums(
        *sums_args(five, small_cells, cfg.ncells)))
    for kcap in SUPERCELL_TIMES_K:
        t5 = [torch.from_numpy(a).cuda()
              for a in adv.adversarial_tiles(kcap, kcap)]
        res, sums = [], []
        for name, lab in adv.label_layouts(kcap, seed=kcap).items():
            lab = torch.from_numpy(lab).cuda()
            res += [t for kind in kinds for t in labelled(t5, lab, *kind)]
            nl = int(lab.max()) + 1
            row = torch.arange(lab.shape[0], device="cuda")[:, None]
            cell = torch.where(lab >= 0, row * nl + lab, -1).to(torch.int32)
            sums += list(cell_pairs.supercell_cell_sums(
                *sums_args(t5, cell, lab.shape[0] * nl)))
        out["digests"][f"adversarial K={kcap} labelled"] = digest(res)
        out["digests"][f"adversarial K={kcap} cell sums"] = digest(sums)
        if kcap in (32, 64, 1024):
            zero = torch.zeros_like(t5[0], dtype=torch.int32)
            out[f"K={kcap} all labels 0 device_ms"] = device_ms(
                lambda: labelled(t5, zero, "v4", True), 20)
    torch.cuda.synchronize()
    with _Clocks() as clocks:
        got = labelled(five, sub, "v4", True)
        m_post = torch.where(got[3] != cell_pairs.INF, 0.0, five[2])
        bound = _labelled_bound(five, sub, m_post, "v4", True)
        out["labelled"] = {
            "ms": _timed(lambda: labelled(five, sub, "v4", True), 20),
            "device_ms": device_ms(lambda: labelled(five, sub, "v4", True),
                                   20),
            "bound_ms": bound[0], "bound_by": bound[1]}
        args = sums_args(five, small_cells, cfg.ncells)
        sbound = _bound(16 * five[0].numel() + 12 * cfg.ncells, 0, 0)
        out["cell sums"] = {
            "ms": _timed(lambda: cell_pairs.supercell_cell_sums(*args), 20),
            "device_ms": device_ms(
                lambda: cell_pairs.supercell_cell_sums(*args), 20),
            "bound_ms": sbound[0], "bound_by": sbound[1]}
        for rec in (out["labelled"], out["cell sums"]):
            rec["share_of_bound"] = rec["bound_ms"] / rec["device_ms"]
    ms, _, _ = step_ms(eng, state, 20)
    times = device_breakdown(f"{root}: SMALL supercell", eng, state, ms)
    out["SMALL"] = {"ms_per_step": ms, "device_ms_per_step": times["device_ms"],
                    "launches": times["launches"], "syncs": times["syncs"]}
    print(f"supercell times {root} on {card}; kernels timed at "
          f"{clocks.summary()}", flush=True)
    print("SUPERCELL_TIMES " + json.dumps(out), flush=True)


def supercell_times_of_all(roots):
    """--supercell-times: each checkout in a process of its own, in turns;
    fails unless every run gives the same output digests."""
    runs = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--supercell-times-of", root], cwd=ROOT,
                              check=True, capture_output=True, text=True)
        print(proc.stdout, end="", flush=True)
        line = next(l for l in proc.stdout.splitlines()
                    if l.startswith("SUPERCELL_TIMES "))
        runs.append((root, json.loads(line.split(" ", 1)[1])))
    first = runs[0][1]["digests"]
    for root, rec in runs[1:]:
        diff = [k for k in first if rec["digests"].get(k) != first[k]]
        if diff:
            raise AssertionError(f"{root}: digests differ from {runs[0][0]}'s "
                                 f"in {diff}")
    print(f"supercell times: every digest equal in all {len(runs)} runs "
          f"({', '.join(r for r, _ in runs)}); on {_card()}", flush=True)


# The paths ``--mesh-times`` times beside the flagship's fast mesh at D =
# 1, 2 and 4: (label, ``_graph_engine``'s kind, args, config and engine
# keywords, steps timed).
MESH_TIMES_PATHS = (
    ("mesh parity D=2", "mesh", GOLDEN_S1[:4],
     {"n_shards": 2, "precision": "parity"}, {}, 20),
    ("mesh parity D=4", "mesh", GOLDEN_S1[:4],
     {"n_shards": 4, "precision": "parity"}, {}, 20),
    ("2D parity (2, 2)", "mesh2d", GOLDEN_S1[:4],
     {"n_shards": 4, "mesh_shape": (2, 2), "precision": "parity"}, {}, 20),
    ("column bands D=4", "mesh", UNEVEN, {"n_shards": 4}, {}, 10),
    ("cyclic D=4", "mesh", UNEVEN, {"n_shards": 4},
     {"impl": "banded-cyclic"}, 10),
    ("mesh supercell D=4", "mesh", SMALL[:4], {"n_shards": 4}, {}, 20),
    ("SMALL supercell", "engine", SMALL[:4], {}, {}, 20),
)


def flagship_mesh_times(root):
    """The flagship's fast mesh (resident tiles by the census) at D = 1, 2
    and 4, then ``MESH_TIMES_PATHS`` (the parity meshes, UNEVEN's column
    and cyclic bands, SMALL's mesh super-cells and SMALL on one device),
    with the port package of the checkout at ``root``: ms/step, device
    ms/step, idle share, launches and syncs a step (phase x's), each path's
    largest device items, and the digest of each run's final state after
    10 steps. Prints one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.ops import graphed
    from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine

    card = _card()
    times = {}

    def timed(label, e, st, k):
        e.run(st, 1)
        t = _mesh_times(f"{root}: {label}", e, st, card, k=k)
        final = e.run(st, 10)
        top = sorted(t["per_kernel_ms"].items(), key=lambda kv: -kv[1])[:6]
        times[label] = {
            "impl": e.impl, "ms_per_step": t["ms"],
            "device_ms_per_step": t["device_ms"], "idle": t["idle"],
            "launches": t["launches"], "syncs": t["syncs"],
            "top": top, "ours": t["kernels"],
            # Launches a step of sort and scan kernels (the parity meshes'
            # plain migration ran two argsorts and a cumsum a hop).
            "sorts": sum(v for k, v in t["per_kernel"].items()
                         if "sort" in k.lower()),
            "scans": sum(v for k, v in t["per_kernel"].items()
                         if "scan" in k.lower()),
            "digest": digest([getattr(final, f) for f in final._fields])}
        graphed.release(getattr(_target(e), "_run", None))
        torch.cuda.empty_cache()

    for d in (1, 2, 4):
        e = ShardedEngine(SimConfig(*GOLDEN_S1[:4], n_shards=d),
                          device="cuda")
        timed(f"mesh fast D={d}", e, e.init_state(), 20)
    for label, kind, args, cfg_kw, eng_kw, k in MESH_TIMES_PATHS:
        timed(label, *_graph_engine(kind, args, cfg_kw, eng_kw), k)
    print(f"mesh times {root} on {card}", flush=True)
    print("MESH_TIMES " + json.dumps(times), flush=True)


# --- Runs as CUDA graphs (phase bc) -----------------------------------------

# (label, engine class, config args, config keywords ("precision":
# "parity" for the parity engine), engine keywords, the engine the census
# must choose, steps checked, steps timed): every path that runs
# ``ops/resident.make_tile_run``, then the sweep (one device, the 1D and 2D
# meshes), dense and tiered runs (``graphed.loop_run``). A graphed run's
# host time overlaps its device time, so a step's time is timed over
# enough steps that the device's part outlasts the run's prologue and
# epilogue.
GRAPH_PATHS = (
    ("flagship resident", "engine", GOLDEN_S1[:4], {}, {}, "resident", 10,
     100),
    ("1e7 resident", "engine", (1, 5000.0, 316, 10_000_000), {},
     {"impl": "resident"}, "resident", 5, 40),
    ("1e7 banded", "engine", (1, 5000.0, 316, 10_000_000), {}, {}, "banded",
     5, 40),
    ("UNEVEN banded", "engine", UNEVEN, {}, {}, "banded", 10, 100),
    ("MEDIUM resident tiles", "engine", MEDIUM[:4], {},
     {"dense_backend": "xla"}, "resident", 10, 40),
    ("SMALL supercell", "engine", SMALL[:4], {}, {}, "supercell", 10, 40),
    ("mesh fast D=4", "mesh", GOLDEN_S1[:4], {"n_shards": 4}, {},
     "resident", 10, 40),
    ("mesh supercell D=4", "mesh", SMALL[:4], {"n_shards": 4}, {},
     "supercell", 10, 40),
    ("column bands D=4", "mesh", UNEVEN, {"n_shards": 4}, {}, "banded", 10,
     40),
    ("cyclic D=4", "mesh", UNEVEN, {"n_shards": 4},
     {"impl": "banded-cyclic"}, "banded", 10, 40),
    ("2D (2, 2)", "mesh2d", GOLDEN_S1[:4],
     {"n_shards": 4, "mesh_shape": (2, 2)}, {}, "resident", 10, 40),
    ("parity s1", "engine", GOLDEN_S1[:4], {"precision": "parity"}, {},
     "sweep", 6, 40),
    ("f32 sweep s1", "engine", GOLDEN_S1[:4], {}, {"impl": "sweep"}, "sweep",
     6, 40),
    ("MEDIUM f32 sweep", "engine", MEDIUM[:4], {}, {}, "sweep", 6, 20),
    ("MEDIUM parity (golden s3)", "engine", MEDIUM[:4],
     {"precision": "parity"}, {}, "sweep", 5, 10),
    ("parity 9 cells (teams off)", "engine", LONG_GOLDEN[0][:4],
     {"precision": "parity"}, {}, "sweep", 6, 40),
    ("mesh parity D=2", "mesh", GOLDEN_S1[:4],
     {"n_shards": 2, "precision": "parity"}, {}, "sweep", 4, 20),
    ("mesh parity D=4", "mesh", GOLDEN_S1[:4],
     {"n_shards": 4, "precision": "parity"}, {}, "sweep", 4, 20),
    ("2D parity (2, 2)", "mesh2d", GOLDEN_S1[:4],
     {"n_shards": 4, "mesh_shape": (2, 2), "precision": "parity"}, {},
     "sweep", 4, 20),
    ("dense flagship", "engine", GOLDEN_S1[:4], {}, {"impl": "dense"},
     "dense", 6, 40),
    ("UNEVEN tiered", "engine", UNEVEN, {}, {"impl": "tiered"}, "tiered", 6,
     40),
    # The 1D row mesh on a DistMesh over NCCL at world size 1 (phase be's
    # mesh): the steps' all-reduces captured in the graphs; resident tiles,
    # the sweep, super-cells (SMALL) and column bands (UNEVEN), each
    # through the census.
    ("DistMesh NCCL fast D=1", "dist", GOLDEN_S1[:4], {"n_shards": 1}, {},
     "resident", 10, 40),
    ("DistMesh NCCL parity D=1", "dist", GOLDEN_S1[:4],
     {"n_shards": 1, "precision": "parity"}, {}, "sweep", 4, 20),
    ("DistMesh NCCL supercell D=1", "dist", SMALL[:4], {"n_shards": 1}, {},
     "supercell", 10, 20),
    ("DistMesh NCCL bands D=1", "dist", UNEVEN, {"n_shards": 1}, {},
     "banded", 10, 20),
)


# The mesh kernels each graph path must launch, beside its own: the
# mesh monopole + integrate on the resident and band meshes, the super-cell
# monopole on SMALL and the mesh's super-cells, the migration pack on the
# parity meshes (at D = 1 the emigrant buffer alone: no ring hop lands
# anything), the stencil tables' kernels on every path that builds tables
# (all but the resident and banded steps, whose monopole pass reads the row
# sums, and the super-cell paths, whose pass builds its terms from the
# cell sums: GRAPH_FORBIDS).
GRAPH_NEEDS = {
    **{label: ("monopole_gathered", *STENCIL_MESH) for label in (
        "mesh fast D=4", "column bands D=4", "cyclic D=4", "2D (2, 2)",
        "DistMesh NCCL fast D=1", "DistMesh NCCL bands D=1")},
    **{label: SC_MONOPOLE for label in (
        "SMALL supercell", "mesh supercell D=4",
        "DistMesh NCCL supercell D=1")},
    **{label: MIGRATE_KERNELS + STENCIL_MESH for label in (
        "mesh parity D=2", "mesh parity D=4", "2D parity (2, 2)")},
    "DistMesh NCCL parity D=1": ("compact", *STENCIL_MESH),
    **{label: ("stencil_grid",) for label in (
        "parity s1", "f32 sweep s1", "MEDIUM f32 sweep",
        "MEDIUM parity (golden s3)", "parity 9 cells (teams off)",
        "dense flagship", "UNEVEN tiered")},
}


GRAPH_FORBIDS = {label: STENCIL_KERNELS for label in (
    "SMALL supercell", "mesh supercell D=4", "DistMesh NCCL supercell D=1")}


def _graph_engine(kind, args, cfg_kw, eng_kw, small=False):
    """(engine, state) of a graph path, built from the seed; ``small``
    starts the tiles below what the run needs (a band plan at 0.7 of its
    census widths, else half the census kcap; where the engine's floor
    keeps the census kcap, as supercell's rows·kcap >= N does at SMALL, 96
    particles moved into particle 0's cell), so that the ladder retries on
    a tile run."""
    from particlesimulation_tpu_torch.config import Precision, SimConfig
    from particlesimulation_tpu_torch.engine import Engine
    from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
    from particlesimulation_tpu_torch.parallel.sharded2d import (
        Sharded2DEngine)

    cls = {"engine": Engine, "mesh": ShardedEngine, "dist": ShardedEngine,
           "mesh2d": Sharded2DEngine}[kind]
    if cfg_kw.get("precision") == "parity":
        cfg_kw = {**cfg_kw, "precision": Precision.PARITY}
    cfg = SimConfig(*args, **cfg_kw)
    # "dist": the 1D row mesh on phase be's NCCL DistMesh of world size 1.
    where = {"mesh": _nccl_mesh()} if kind == "dist" else {"device": "cuda"}
    eng = cls(cfg, **where, **eng_kw)
    state = eng.init_state()
    if not small:
        return eng, state
    target = _target(eng)
    if getattr(target, "_band_plan", None) is not None:
        target._band_plan = tuple((r0, rw, max(8, int(k * 0.7)))
                                  for r0, rw, k in target._band_plan)
    else:
        target._build()
        census = target.kcap
        eng = cls(cfg, **where, kcap=max(8, census // 2), **eng_kw)
        state = eng.init_state()
        _target(eng)._build()
        if _target(eng).kcap >= census:
            state = _crowd(state, cfg, 96)
    _target(eng)._build()
    return eng, state


def _crowd(state, cfg, n):
    """A one-device state with particles 1..n moved to seeded places in
    particle 0's cell."""
    g = torch.Generator().manual_seed(0)
    w = cfg.side / cfg.ncside
    x, y = state.x.clone(), state.y.clone()
    for a in (x, y):
        corner = float(torch.floor(a[0] / w)) * w
        a[1:n + 1] = (corner + w * (0.05 + 0.9 * torch.rand(
            n, generator=g, dtype=torch.float64))).to(a.dtype).to(a.device)
    return state._replace(x=x, y=y)


def _target(eng):
    """The engine that holds a mesh's slabs and builds its runs (a 2D
    mesh's delegate where the census chose one)."""
    return eng.target() if hasattr(eng, "target") else eng


def _graphed_run_of(eng):
    """The ``graphed.GraphedRun`` an engine built last (a 2D mesh's
    delegate's where the census chose one)."""
    from particlesimulation_tpu_torch.ops import graphed

    target = _target(eng)
    run = target._run
    if not isinstance(run, graphed.GraphedRun):
        raise AssertionError(f"{type(eng).__name__} ran {target.impl}: no "
                             f"graphed run")
    return run


def _state_bits(state):
    """Every field of a SimState or ShardedState on the host."""
    return {f: getattr(state, f).detach().cpu().clone() for f in state._fields}


def _bitwise(label, a, b):
    """Two states' fields bit for bit (floats by their bit patterns)."""
    bad = [f for f in a if not _bits_equal(a[f], b[f])]
    if bad:
        raise AssertionError(f"{label}: fields {bad} differ")


def _pool_bytes(pool):
    """Bytes the caching allocator holds for a graph pool (None where the
    snapshot names no pools)."""
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s["segment_pool_id"]) == tuple(pool))


def _replays_sync_free(label, graphs):
    """Three replays of every captured step on the carry as it stands,
    under ``torch.cuda.set_sync_debug_mode("error")``: any synchronising
    call raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            for name in graphs.names:
                graphs.step(name, None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"{label}: 3 replays of {', '.join(graphs.names)} with no host "
          f"synchronisation", flush=True)


# Profiles of a graph path's graphed and eager runs taken again, at most,
# where a side's counts are not whole or the two differ.
PROFILE_RETRIES = 12


def check_graph_path(card, label, kind, args, cfg_kw, eng_kw, want, k,
                     k_time):
    """(bc) One path: the graphed run against the eager one, bit for bit,
    from one state; the same engine on a second state (the first run's
    result) against its eager run, its graphs reused, the first result
    unchanged after it; on a tile path (resident, supercell, banded, the
    meshes' tiles, dense) a forced retry graphed against eager; no host
    sync in the replays; the profile's kernels a step graphed against
    eager; ms/step, device ms/step and idle share of both, the capture's
    host time and the graphs' pool bytes. Returns the path's record."""
    from particlesimulation_tpu_torch.ops import graphed

    t0 = time.perf_counter()
    eng, state = _graph_engine(kind, args, cfg_kw, eng_kw)
    reset_launches()
    reset_sweep_launches()
    first = eng.run(state, k)
    torch.cuda.synchronize()
    launches = read_launches()
    if want == "sweep":
        # The graphed sweep's launches (the replays' included), for the
        # kernels line: each of its four kernels must have launched.
        launches = read_sweep_launches(f"{label} (bc, graphed)")
    require_launches(f"{label} (bc, graphed)", launches,
                     GRAPH_NEEDS.get(label, ()))
    forbid_launches(f"{label} (bc, graphed)", launches,
                    GRAPH_FORBIDS.get(label, ()))
    if eng.impl != want or int(first.overflow) != 0:
        raise AssertionError(f"{label}: ran {eng.impl} (want {want}), "
                             f"overflow {int(first.overflow)}")
    run = _graphed_run_of(eng)
    graphs = run.graphs
    captured = {name: graphs._graphs[name][0] for name in graphs.names}
    a = _state_bits(first)
    _bitwise(f"{label}: graphed vs eager", a,
             _state_bits(eng.run_eager(state, k)))
    # The same engine on a second state: the graphs reused, the carry
    # loaded anew; the first result untouched.
    second = eng.run(first, k)
    if {n: graphs._graphs[n][0] for n in graphs.names} != captured:
        raise AssertionError(f"{label}: the second run captured anew")
    _bitwise(f"{label}: second state, graphed vs eager",
             _state_bits(second), _state_bits(eng.run_eager(first, k)))
    _bitwise(f"{label}: the first result after the second run", a,
             _state_bits(first))
    # A retry forced by small tiles: graphed against eager on two engines
    # built alike (the sweep has no tiles; tiered's plan comes from the
    # census of a run without a given kcap).
    retried = "none (no tile retry on this path)"
    if want not in ("sweep", "tiered"):
        e1, s1_ = _graph_engine(kind, args, cfg_kw, eng_kw, small=True)
        k0 = _target(e1).kcap
        r1 = e1.run(s1_, k)
        e2, s2_ = _graph_engine(kind, args, cfg_kw, eng_kw, small=True)
        r2 = e2.run_eager(s2_, k)
        k1 = _target(e1).kcap
        if (k1 or 0) <= k0 or e1.impl != e2.impl or e1.kcap != e2.kcap:
            raise AssertionError(f"{label}: no retry (kcap {k0} -> {k1}, "
                                 f"{e1.impl} vs {e2.impl})")
        _bitwise(f"{label}: retried, graphed vs eager", _state_bits(r1),
                 _state_bits(r2))
        retried = f"{e1.impl} kcap {k0} -> {k1}"
        for e in (e1, e2):
            graphed.release(_target(e)._run)
        del e1, e2, r1, r2
    _replays_sync_free(label, graphs)
    # Time both in the same call, and profile both.
    rec = {"impl": eng.impl, "kcap": eng.kcap, "launches": launches,
           "retried": retried,
           "capture_s": dict(graphs.capture_s),
           "pool_bytes": _pool_bytes(graphs.pool)}
    for tag, fn in (("graphed", eng.run), ("eager", eng.run_eager)):
        ms, _, _ = step_ms(eng, state, k_time, run=fn)
        times = device_breakdown(f"{label} {tag}", eng, state, ms, steps=k,
                                 run=fn, base=1)
        rec[tag] = {"ms": ms, "device_ms": times["device_ms"],
                    "idle": times["idle"], "launches": times["launches"],
                    "syncs": times["syncs"],
                    "per_kernel": times["per_kernel"]}

    def whole(r):
        # Every kernel a whole number of launches a step, and no more
        # device time than the step took: no record lost or misplaced.
        return (all(abs(n - round(n)) < 1e-9
                    for n in r["per_kernel"].values())
                and r["idle"] > -0.05)

    for _ in range(PROFILE_RETRIES):
        if (whole(rec["graphed"]) and whole(rec["eager"])
                and rec["graphed"]["launches"] == rec["eager"]["launches"]):
            break
        # The profiler has lost or misplaced kernel records before (a
        # count off by a fraction or by a stray record, or more device time
        # than the step took), on one side for several profiles running:
        # name the kernels whose counts differ, then profile again the
        # side whose counts are not whole, or both where both are.
        print(f"{label}: kernels a step that differ, graphed / eager: "
              + _kernel_count_diff(rec["graphed"]["per_kernel"],
                                   rec["eager"]["per_kernel"]), flush=True)
        again = [tag for tag in ("graphed", "eager") if not whole(rec[tag])]
        for tag, fn in (("graphed", eng.run), ("eager", eng.run_eager)):
            if again and tag not in again:
                continue
            times = device_breakdown(f"{label} {tag} (again)", eng, state,
                                     rec[tag]["ms"], steps=k, run=fn, base=1)
            rec[tag].update(device_ms=times["device_ms"], idle=times["idle"],
                            launches=times["launches"],
                            per_kernel=times["per_kernel"])
    if rec["graphed"]["launches"] != rec["eager"]["launches"]:
        raise AssertionError(
            f"{label}: {rec['graphed']['launches']} kernels a step graphed, "
            f"{rec['eager']['launches']} eager: "
            + _kernel_count_diff(rec["graphed"]["per_kernel"],
                                 rec["eager"]["per_kernel"]))
    if rec["graphed"]["syncs"] != 0:
        raise AssertionError(f"{label}: host syncs in the graphed steps")
    scans = [key for r in (rec["graphed"], rec["eager"])
             for key in r["per_kernel"] if "scan" in key]
    if set(MIGRATE_KERNELS) <= set(GRAPH_NEEDS.get(label, ())) and scans:
        # The parity meshes' migration: the pack kernels, no cumsum left
        # (the sweep's step runs no other scan).
        raise AssertionError(f"{label}: scan kernels in the step: {scans}")
    g, e = rec["graphed"], rec["eager"]
    for r in (g, e):
        del r["per_kernel"]
    pool = ("not measured" if rec["pool_bytes"] is None
            else f"{rec['pool_bytes'] / 2**20:.1f} MiB")
    print(f"{label} ({eng.impl}, kcap {eng.kcap}, {k} steps checked, "
          f"{k_time} timed): graphed "
          f"{g['ms']:.4f} ms/step, {g['device_ms']:.4f} device ms/step, idle "
          f"{g['idle']:.1%}; eager {e['ms']:.4f} ms/step, "
          f"{e['device_ms']:.4f} device ms/step, idle {e['idle']:.1%}; "
          f"{g['launches']:.1f} kernels a step both; capture "
          + ", ".join(f"{n} {v * 1e3:.1f} ms" for n, v in
                      rec["capture_s"].items())
          + f"; graph pool {pool}; retry {retried}; bit for bit graphed = "
          f"eager on the first state, a second state and any retry "
          f"({time.perf_counter() - t0:.1f} s) on {card}", flush=True)
    run.release()
    del eng, state, first, second
    torch.cuda.empty_cache()
    return rec


def _kernel_count_diff(graphed, eager):
    """The kernels whose launches a step differ between two profiles
    ({name: launches a step}), each as "name graphed / eager"; "none" if
    only the totals or the idle share were off."""
    diff = [f"{key[:60]} {graphed.get(key, 0):.2f} / {eager.get(key, 0):.2f}"
            for key in sorted(set(graphed) | set(eager))
            if abs(graphed.get(key, 0) - eager.get(key, 0)) > 1e-9]
    return "; ".join(diff) or "none"


def check_long_lived(label, eng, state, steps, bits, captures):
    """A run's graphs replayed long after their capture, other phases'
    graphs made, replayed and dropped in between: ``eng.run(state,
    steps)`` must give ``bits`` again with no capture beyond ``captures``
    (the count when ``bits`` were taken)."""
    graphs = eng._run.graphs
    _bitwise(f"{label}: graphs replayed after later phases", bits,
             _state_bits(eng.run(state, steps)))
    if graphs.captures != captures:
        raise AssertionError(f"{label}: {graphs.captures - captures} new "
                             f"captures after later phases")
    print(f"{label}: graphs captured in an earlier phase replayed, bit for "
          f"bit as then, no new capture ({captures} in all)", flush=True)


def check_capture_raises():
    """(bc) A step that reads a value back to the host cannot be captured:
    ``StepGraph.step`` raises, with no eager fallback; the card still
    runs after it."""
    from particlesimulation_tpu_torch.ops import graphed

    sg = graphed.StepGraph(counters=())
    sg.load((torch.ones(1024, device="cuda"),))

    def reads_back(x):
        return (x * 2.0 if float(x.sum()) > 0 else x,)

    try:
        sg.step("reads back", reads_back)
    except RuntimeError as err:
        msg = "; ".join(str(e).splitlines()[0][:100]
                        for e in (err.__context__, err) if e is not None)
    else:
        raise AssertionError("a capture with a host readback did not raise")
    if sg.names:
        raise AssertionError("a failed capture left a graph")
    torch.cuda.synchronize()
    if float((torch.ones(10, device="cuda") * 2).sum()) != 20.0:
        raise AssertionError("the card after a failed capture")
    print(f"a step with a host readback: the capture raised ({msg}); the "
          f"card runs on", flush=True)


def check_graphs(card):
    """(bc) Every path of ``GRAPH_PATHS`` graphed against eager
    (``check_graph_path``), then a capture that must raise. Returns
    {label: record}."""
    t0 = time.perf_counter()
    recs = {}
    for label, *path in GRAPH_PATHS:
        recs[label] = check_graph_path(card, label, *path)
    check_capture_raises()
    print(f"runs as CUDA graphs (bc): {len(recs)} paths, "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
    print("GRAPH_TIMES " + json.dumps(recs), flush=True)
    return recs


# --- The COM kernel's launches back to back (phase bd) ----------------------

# Lanes a cell of the round cases: about the kernel's rounds (32 to 1024
# lanes a cell, by how many cells share a group of 32) and past them.
COM_ROUND_LANES = (1, 31, 32, 33, 64, 65, 100, 257, 1023, 1024, 1025, 2050,
                   5000)
COM_BTB_SIDE, COM_BTB_NCSIDE = 64.0, 64
COM_BTB_PASSES = 3


def _com_round_particles(lanes, seed):
    """(x, y, m, alive): cells of ``lanes`` lanes each (``lanes`` an int),
    or of mixed sizes from 1 to 1100 (``lanes`` None), at seeded cells of
    the 64 x 64 unit-cell box among empty ones; masses U(0.5, 2), a tenth
    massless (alive where m > 0)."""
    rng = np.random.default_rng(seed)
    ncells = COM_BTB_NCSIDE * COM_BTB_NCSIDE
    if lanes is None:
        sizes = np.minimum(rng.geometric(1 / 60, 300), 1100)
    else:
        sizes = np.full(max(1, min(300, 20_000 // lanes)), lanes)
    cells = rng.choice(ncells, sizes.shape[0], replace=False)
    cx = np.repeat(cells % COM_BTB_NCSIDE, sizes)
    cy = np.repeat(cells // COM_BTB_NCSIDE, sizes)
    n = int(sizes.sum())
    x = cx + rng.uniform(0.0, 1.0, n)
    y = cy + rng.uniform(0.0, 1.0, n)
    m = np.where(rng.uniform(size=n) < 0.1, 0.0, rng.uniform(0.5, 2.0, n))
    return x, y, m, m > 0


def check_com_back_to_back(card):
    """(bd) ``sweep.sweep_com`` launched back to back in one process on
    differing layouts: cells of each of ``COM_ROUND_LANES`` lanes, cells of
    mixed sizes, ``adversarial.com_particles`` and golden s1's lanes, in
    f64 (parity) and f32, sorted and in the mesh's layout;
    ``COM_BTB_PASSES`` passes over every case in a seeded order, each
    launch held bit for bit against the plain version in parity
    (``sweep_com_ref``) and against the sums in position order in f32 (its
    kernel's order; ``_position_order_com``). Fails on any mismatch."""
    from particlesimulation_tpu_torch.ops.cuda import adversarial as adv
    from particlesimulation_tpu_torch.ops.cuda import sweep

    t0 = time.perf_counter()
    sources = [(f"cells of {c} lanes", _com_round_particles(c, 100 + i),
                COM_BTB_SIDE, COM_BTB_NCSIDE)
               for i, c in enumerate(COM_ROUND_LANES)]
    sources.append(("cells of mixed sizes", _com_round_particles(None, 99),
                    COM_BTB_SIDE, COM_BTB_NCSIDE))
    sources.append(("adversarial COM case", adv.com_particles(),
                    adv.COM_SIDE, adv.COM_NCSIDE))
    cases = []
    for label, parts, side, nc in sources:
        for dtype in (torch.float64, torch.float32):
            lanes = _sorted_lanes(*parts, dtype, side, nc)
            for layout, (x, y, m, _, key, pos), plan in _layouts(lanes,
                                                                 nc * nc):
                cases.append((f"{label}, {dtype}, {layout}",
                              (x, y, m, key, pos, plan, nc * nc)))
    for parity in (True, False):
        st = _sweep_state(GOLDEN_S1, parity)
        key, pos, plan = _sweep_lanes(st.x, st.y, GOLDEN_S1[1], GOLDEN_S1[2])
        cases.append((f"golden s1 lanes, {st.x.dtype}, sorted",
                      (st.x, st.y, st.m, key, pos, plan,
                       GOLDEN_S1[2] ** 2)))
    refs = []
    for _, (x, y, m, key, pos, plan, ncells) in cases:
        if x.dtype == torch.float64:
            refs.append(sweep.sweep_com_ref(x, y, m, key, pos, plan, ncells))
        else:
            refs.append(_position_order_com(x, y, m, key, pos, plan, ncells))
    rng = np.random.default_rng(21)
    launches, bad = 0, []
    for _ in range(COM_BTB_PASSES):
        for i in rng.permutation(len(cases)):
            label, (x, y, m, key, pos, plan, ncells) = cases[i]
            got = sweep.sweep_com(x, y, m, key, pos, plan, ncells)
            launches += 1
            if not all(_float_bits_equal(a, b) for a, b in zip(got,
                                                               refs[i])):
                bad.append(label)
    print(f"COM kernel back to back (bd): {launches} launches over "
          f"{len(cases)} layouts ({COM_BTB_PASSES} passes in a seeded "
          f"order), {len(bad)} differing from the plain version"
          + (f": {sorted(set(bad))}" if bad else "")
          + f" ({time.perf_counter() - t0:.1f} s) on {card}", flush=True)
    if bad:
        raise AssertionError(f"COM kernel back to back: {len(bad)} launches "
                             f"differ")
    return launches


# --- The torch.distributed mesh (phase be) ----------------------------------

# Phase be's paths on a DistMesh: (label, config args, SimConfig keywords,
# engine keywords, 2D mesh, the route the census must take, the kernels the
# run must launch, steps, particle 0 and the count after them (None: golden
# s1's lines), the world sizes it runs at: 1 is NCCL in this process, 2 and
# 4 gloo ranks sharing the card). A 2D path's mesh is (1, 1) at world size 1
# and (2, 2) at 4. Every route of both mesh engines: resident tiles and the
# sweep (golden s1), super-cells (SMALL, through the census), column bands
# (UNEVEN, through the census) and block-cyclic bands, rectangle tiles and
# the 2D sweep, and the 2D census's delegation to super-cells.
SC_KERNELS = ("fused_pairs_sub", "supercell_cell_sums", "deliver",
              *SC_MONOPOLE)
BAND_KERNELS = ("fused_pairs", "deliver", "monopole_gathered", *STENCIL_MESH)
DIST_PATHS = (
    ("flagship fast", GOLDEN_S1[:4], {}, {}, False, "resident",
     ("fused_pairs", "monopole_gathered", *STENCIL_MESH), GOLDEN_S1[4], None,
     (1, 2, 4)),
    ("parity s1", GOLDEN_S1[:4], {"precision": "parity"}, {}, False, "sweep",
     SWEEP_KERNELS, GOLDEN_S1[4], None, (1, 2, 4)),
    ("SMALL census", SMALL[:4], {}, {}, False, "supercell", SC_KERNELS,
     SMALL[4], SMALL_10, (1, 2, 4)),
    ("UNEVEN census", UNEVEN, {}, {}, False, "banded", BAND_KERNELS, 2,
     UNEVEN_2, (1, 2, 4)),
    ("UNEVEN cyclic", UNEVEN, {}, {"impl": "banded-cyclic"}, False, "banded",
     BAND_KERNELS, 2, UNEVEN_2, (1, 2, 4)),
    ("flagship 2D fast", GOLDEN_S1[:4], {}, {}, True, "resident",
     BAND_KERNELS, GOLDEN_S1[4], None, (1, 4)),
    ("flagship 2D parity", GOLDEN_S1[:4], {"precision": "parity"}, {}, True,
     "sweep", SWEEP_KERNELS, GOLDEN_S1[4], None, (1, 4)),
    ("SMALL 2D delegated", SMALL[:4], {}, {}, True, "supercell", SC_KERNELS,
     SMALL[4], SMALL_10, (4,)),
)
DIST_WORLDS = (2, 4)
DIST_TIMEOUT = 420.0
# The checkpoint's path: parity s1, saved after 2 steps, 2 more after.
DIST_CKPT = "parity s1"


def _nccl_mesh():
    """This process's ``DistMesh`` on cuda:0 over an NCCL group of world
    size 1, initialised once through a ``file://`` store and destroyed at
    exit."""
    import atexit
    import tempfile

    import torch.distributed as dist
    from particlesimulation_tpu_torch.parallel.mesh import DistMesh

    if not dist.is_initialized():
        torch.cuda.set_device(0)
        store = os.path.join(tempfile.mkdtemp(), "store")
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=0, world_size=1)
        atexit.register(dist.destroy_process_group)
    return DistMesh("cuda:0")


def _path(label):
    return next(p for p in DIST_PATHS if p[0] == label)


def _dist_engine(path, d, mesh):
    """A path's engine of ``d`` shards on ``mesh`` (a 1D ``DistMesh``; a 2D
    path takes the mesh of its shape over the same group), or, where
    ``mesh`` is None, on its ``LocalMesh`` on the card."""
    from particlesimulation_tpu_torch.config import Precision, SimConfig
    from particlesimulation_tpu_torch.parallel.mesh import DistMesh
    from particlesimulation_tpu_torch.parallel.sharded import ShardedEngine
    from particlesimulation_tpu_torch.parallel.sharded2d import (
        Sharded2DEngine)

    _, args, cfg_kw, eng_kw, mesh2d = path[:5]
    if cfg_kw.get("precision") == "parity":
        cfg_kw = {**cfg_kw, "precision": Precision.PARITY}
    shape = (1, 1) if d == 1 else (2, d // 2)
    if mesh2d:
        cfg_kw = {**cfg_kw, "mesh_shape": shape}
    cfg = SimConfig(*args, n_shards=d, **cfg_kw)
    cls = Sharded2DEngine if mesh2d else ShardedEngine
    if mesh is None:
        return cls(cfg, device="cuda", **eng_kw)
    if mesh2d:
        mesh = DistMesh(mesh.device, shape)
    return cls(cfg, mesh=mesh, **eng_kw)


def _gathered_digest(eng, state):
    """The digest of the mesh's particles in pid order (every rank's)."""
    g = eng.gather(state)
    return digest([torch.from_numpy(np.ascontiguousarray(g[f]))
                   for f in MESH_FIELDS])


def _path_launches(path, tag=None, d=1):
    """The launch counts of a path's kernels since they were set to 0
    (tile and sweep kernels), each required non-zero; with ``tag``, a sweep
    path's counts recorded for the kernels line. A parity path (a mesh's
    sweep, of ``d`` shards) must also launch the migration's emigrant
    buffer, and its landing where a ring hop (d > 1) or the 2D mesh's
    landing runs."""
    label, kernels = path[0], path[6]
    if kernels is SWEEP_KERNELS:
        got = read_sweep_launches(tag or label)
        require_launches(label, got, ("compact",) + (
            ("pack",) if d > 1 or path[4] else ()))
        return got
    got = read_launches()
    if not all(got[k] > 0 for k in kernels):
        raise AssertionError(f"a kernel of {label} did not launch: {got}")
    if kernels is SC_KERNELS:
        forbid_launches(label, got, STENCIL_KERNELS)
    return got


def _lines_ok(path, eng, out):
    """Particle 0 and the count against the path's values: golden s1's
    lines exactly in parity, within GOLDEN_TOL in f32 (count exact)."""
    x, y, c = eng.result(out)
    want = path[8]
    if want is None:
        ex, ey, ec = GOLDEN_S1[5:]
        if path[2].get("precision") == "parity":
            return (f"{x:.3f} {y:.3f}", c) == (f"{ex:.3f} {ey:.3f}", ec)
    else:
        ex, ey, ec = want
    return c == ec and abs(x - ex) <= GOLDEN_TOL and abs(y - ey) <= GOLDEN_TOL


def _load_npz(path):
    with np.load(path) as z:
        return {f: z[f] for f in z.files}


def _same_files(label, a, b):
    """Two checkpoints array for array (names, dtypes, values)."""
    fa, fb = _load_npz(a), _load_npz(b)
    bad = sorted(f for f in set(fa) | set(fb)
                 if f not in fa or f not in fb or fa[f].dtype != fb[f].dtype
                 or not np.array_equal(fa[f], fb[f]))
    if bad:
        raise AssertionError(f"{label}: arrays {bad} differ")


def _checkpoint_run(eng, path, steps):
    """``steps`` steps, saved to ``path`` (every rank calls the save),
    restored onto the same engine (each rank its own slab, as saved) and
    ``steps`` more: (the continued state, whether the restored state is
    the saved one bit for bit)."""
    from particlesimulation_tpu_torch.utils import checkpointing

    run = eng.run if eng.mesh.capturable else eng.run_eager
    mid = run(eng.init_state(), steps)
    checkpointing.save_sharded_state(path, mid, engine=eng)
    restored = checkpointing.restore_sharded(path, eng)
    a, b = _state_bits(restored), _state_bits(mid)
    return run(restored, steps), all(_bits_equal(a[f], b[f]) for f in a)


def _dist_rank(rank, world, backend, tmp):
    """One rank of a ``DistMesh`` group spawned by ``check_dist_ranks``:
    gloo ranks share cuda:0 and run eagerly (their collectives pass
    through host memory: ``run`` must refuse them), NCCL ranks take a card
    each and run graphed. Each path of ``DIST_PATHS`` at this world size
    for its steps (golden s1's timed), then the checkpoint; each rank
    writes its record as JSON."""
    import datetime

    import torch.distributed as dist
    from particlesimulation_tpu_torch.parallel.mesh import DistMesh

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT / 2))
    recs = {}
    try:
        mesh = DistMesh(dev)
        for path in DIST_PATHS:
            if world not in path[9]:
                continue
            label, steps = path[0], path[7]
            t0 = time.perf_counter()
            eng = _dist_engine(path, world, mesh)
            state = eng.init_state()
            run = eng.run if backend == "nccl" else eng.run_eager
            torch.cuda.synchronize()
            reset_launches()
            reset_sweep_launches()
            out = run(state, steps)
            torch.cuda.synchronize()
            launches = _path_launches(path, d=world)
            refused = None
            if backend == "gloo":
                try:
                    eng.run(state, steps)
                except ValueError as err:
                    refused = str(err)
            ms = None
            if path[1] == GOLDEN_S1[:4] and not path[4]:
                ms, _, _ = step_ms(eng, state, 3, reps=1, run=run)
            recs[label] = {"impl": eng.impl, "digest": _gathered_digest(
                eng, out), "collisions": int(out.collisions),
                "result": eng.result(out), "launches": launches,
                "ms": ms, "refused": refused,
                "seconds": time.perf_counter() - t0}
            del eng, state, out
            torch.cuda.empty_cache()
        if world == 4:
            eng = _dist_engine(_path(DIST_CKPT), world, mesh)
            out, same = _checkpoint_run(eng, os.path.join(tmp, "ckpt.npz"),
                                        2)
            recs["checkpoint"] = {"digest": _gathered_digest(eng, out),
                                  "as_saved": same}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(recs, f)


def _spawn_ranks(world, backend, tmp):
    """Spawn ``world`` ranks of ``_dist_rank`` and wait for them (a rank
    that raises, or DIST_TIMEOUT seconds, ends them all and raises);
    returns each rank's records."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_dist_rank, args=(world, backend, tmp),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DIST_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"{backend} ranks still running after "
                                     f"{DIST_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def check_dist_nccl(card):
    """(be i) NCCL at world size 1 on cuda:0: every path of DIST_PATHS at
    world size 1 on a ``DistMesh`` (the 2D ones on its (1, 1) mesh),
    graphed (its all-reduces captured in the step's graph) against eager
    bit for bit, three sync-free replays, particle 0 and the count, the
    final state's digest against ``LocalMesh(1)``'s, the path's kernels
    launched, ms/step; then a checkpoint saved and restored mid-run,
    continuing bit for bit, its file ``LocalMesh(1)``'s. Returns each
    path's launches."""
    import tempfile

    from particlesimulation_tpu_torch.ops import graphed

    mesh = _nccl_mesh()
    launches = {}
    for path in DIST_PATHS:
        label, want, steps = path[0], path[5], path[7]
        if 1 not in path[9]:
            continue
        tag = f"DistMesh NCCL D=1 {label}"
        eng = _dist_engine(path, 1, mesh)
        state = eng.init_state()
        torch.cuda.synchronize()
        reset_launches()
        reset_sweep_launches()
        out = eng.run(state, steps)
        torch.cuda.synchronize()
        launches[label] = _path_launches(path, tag)
        x, y, c = eng.result(out)
        if (eng.impl != want or int(out.overflow) != 0
                or not _lines_ok(path, eng, out)):
            raise AssertionError(f"{tag}: {eng.impl}, overflow "
                                 f"{int(out.overflow)}, ({x}, {y}, {c})")
        bits = _state_bits(out)
        _bitwise(f"{tag}: graphed vs eager", bits,
                 _state_bits(eng.run_eager(state, steps)))
        run = _graphed_run_of(eng)
        _replays_sync_free(tag, run.graphs)
        local = _dist_engine(path, 1, None)
        lbits = _state_bits(local.run(local.init_state(), steps))
        got, ref = (digest(list(b.values())) for b in (bits, lbits))
        if got != ref:
            raise AssertionError(f"{tag}: digest {got} vs LocalMesh(1)'s "
                                 f"{ref}")
        graphed.release(_graphed_run_of(local))
        ms, _, _ = step_ms(eng, state, steps)
        print(f"{tag}: {eng.impl}, kcap {_target(eng).kcap}, particle 0 "
              f"({x:.4f}, {y:.4f}), {c} collisions, graphed = eager bit for "
              f"bit, digest {got[:16]} = LocalMesh(1)'s, {ms:.4f} ms/step "
              f"graphed, launches {launches[label]} on {card}", flush=True)
        graphed.release(run)
        del eng, state, out, local
        torch.cuda.empty_cache()
    # The checkpoint: saved from the DistMesh, restored onto it (as saved)
    # and continued; the file against LocalMesh(1)'s, the continued state
    # against LocalMesh(1)'s.
    tmp = tempfile.mkdtemp()
    files = {}
    ends = {}
    for where, m in (("DistMesh", mesh), ("LocalMesh", None)):
        eng = _dist_engine(_path(DIST_CKPT), 1, m)
        files[where] = os.path.join(tmp, f"{where}.npz")
        out, same = _checkpoint_run(eng, files[where], 2)
        if not same:
            raise AssertionError(f"NCCL D=1 checkpoint on {where}: the "
                                 f"restored state is not the saved one")
        ends[where] = digest(list(_state_bits(out).values()))
        graphed.release(_graphed_run_of(eng))
    _same_files("NCCL D=1 checkpoint vs LocalMesh(1)'s", files["DistMesh"],
                files["LocalMesh"])
    if ends["DistMesh"] != ends["LocalMesh"]:
        raise AssertionError(f"NCCL D=1 checkpoint: continued digest "
                             f"{ends['DistMesh']} vs LocalMesh(1)'s "
                             f"{ends['LocalMesh']}")
    print(f"DistMesh NCCL D=1 checkpoint ({DIST_CKPT}, 2 steps saved, 2 "
          f"more): restored as saved bit for bit, the file LocalMesh(1)'s "
          f"array for array, continued digest {ends['DistMesh'][:16]} = "
          f"LocalMesh(1)'s on {card}", flush=True)
    return launches


def check_dist_ranks(card):
    """(be ii, iii) gloo ranks sharing cuda:0 at D = 2 and 4, spawned, each
    path of DIST_PATHS at that size eagerly: every rank's route, digest and
    count equal to the ``LocalMesh`` engine's of the same shape on the
    card, ``run`` refused; at D = 4 a checkpoint whose file is the
    ``LocalMesh``'s array for array and whose continued run is its; then
    NCCL across cards at D = 2, graphed, where the machine has two
    cards."""
    import tempfile

    from particlesimulation_tpu_torch.ops import graphed

    cases = [("gloo", d) for d in DIST_WORLDS]
    if torch.cuda.device_count() >= 2:
        cases.append(("nccl", 2))
    else:
        print(f"be iii, NCCL across cards at D = 2: not run (this machine "
              f"has {torch.cuda.device_count()} card; NCCL refuses two "
              f"ranks on one card)", flush=True)
    for backend, d in cases:
        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp()
        ranks = _spawn_ranks(d, backend, tmp)
        for path in DIST_PATHS:
            label, want, steps = path[0], path[5], path[7]
            if d not in path[9]:
                continue
            local = _dist_engine(path, d, None)
            lout = local.run(local.init_state(), steps)
            ref = _gathered_digest(local, lout)
            graphed.release(_graphed_run_of(local))
            for r, rec in enumerate(ranks):
                got = rec[label]
                if (got["digest"] != ref or got["impl"] != want
                        or local.impl != want
                        or got["collisions"] != int(lout.collisions)):
                    raise AssertionError(
                        f"{backend} D={d} {label}, rank {r}: {got['impl']}, "
                        f"{got['collisions']} collisions, digest "
                        f"{got['digest']} vs LocalMesh D={d}'s {local.impl}, "
                        f"{int(lout.collisions)}, {ref}")
                if backend == "gloo" and "run_eager" not in (got["refused"]
                                                             or ""):
                    raise AssertionError(f"gloo D={d} {label}, rank {r}: "
                                         f"run was not refused")
            note = ("host-staged gloo collectives on one card — not a "
                    "scaling number" if backend == "gloo"
                    else "NCCL across cards, graphed")
            ms = ("" if ranks[0][label]["ms"] is None else
                  "ms/step by rank " + ", ".join(
                      f"{rec[label]['ms']:.2f}" for rec in ranks) + ", ")
            print(f"DistMesh {backend} D={d} {label}: {want}, "
                  f"{ranks[0][label]['collisions']} collisions, every "
                  f"rank's digest {ref[:16]} = LocalMesh D={d}'s; {ms}"
                  f"{ranks[0][label]['seconds']:.1f} s of rank 0 ({note}); "
                  f"rank 0's launches {ranks[0][label]['launches']} on "
                  f"{card}", flush=True)
            del local, lout
            torch.cuda.empty_cache()
        if d == 4:
            local = _dist_engine(_path(DIST_CKPT), d, None)
            lfile = os.path.join(tmp, "local.npz")
            lout, same = _checkpoint_run(local, lfile, 2)
            ref = _gathered_digest(local, lout)
            graphed.release(_graphed_run_of(local))
            _same_files(f"{backend} D=4 checkpoint vs LocalMesh D=4's",
                        os.path.join(tmp, "ckpt.npz"), lfile)
            for r, rec in enumerate(ranks):
                got = rec["checkpoint"]
                if not (same and got["as_saved"]) or got["digest"] != ref:
                    raise AssertionError(f"{backend} D=4 checkpoint, rank "
                                         f"{r}: {got} vs {ref}")
            print(f"DistMesh {backend} D=4 checkpoint ({DIST_CKPT}, 2 steps "
                  f"saved, 2 more): the file LocalMesh D=4's array for "
                  f"array, every rank restored as saved, continued digest "
                  f"{ref[:16]} = LocalMesh's on {card}", flush=True)
        print(f"DistMesh {backend} D={d}: {time.perf_counter() - t0:.1f} s",
              flush=True)


def check_dist(card):
    """(be) The ``torch.distributed`` mesh; returns the NCCL paths'
    launches."""
    t0 = time.perf_counter()
    launches = check_dist_nccl(card)
    check_dist_ranks(card)
    print(f"DistMesh phases (be): {time.perf_counter() - t0:.1f} s on "
          f"{card}", flush=True)
    return launches


# --- The migration pack and the mesh monopole + integrate (phase bf) -------

# The parity meshes whose migration calls phase bf holds the pack to, and
# the tile engines whose monopole + integrate calls it holds the mesh
# kernel to (``_graph_engine``'s kind, args, config and engine keywords).
BF_PACK_PATHS = (
    ("mesh parity D=2", "mesh", GOLDEN_S1[:4],
     {"n_shards": 2, "precision": "parity"}, {}),
    ("mesh parity D=4", "mesh", GOLDEN_S1[:4],
     {"n_shards": 4, "precision": "parity"}, {}),
    ("2D parity (2, 2)", "mesh2d", GOLDEN_S1[:4],
     {"n_shards": 4, "mesh_shape": (2, 2), "precision": "parity"}, {}),
)
BF_MONOPOLE_PATHS = (
    ("mesh fast D=4", "mesh", GOLDEN_S1[:4], {"n_shards": 4}, {}),
    ("2D (2, 2)", "mesh2d", GOLDEN_S1[:4],
     {"n_shards": 4, "mesh_shape": (2, 2)}, {}),
    ("mesh supercell D=4", "mesh", SMALL[:4], {"n_shards": 4}, {}),
    ("column bands D=4", "mesh", UNEVEN, {"n_shards": 4}, {}),
    ("cyclic D=4", "mesh", UNEVEN, {"n_shards": 4},
     {"impl": "banded-cyclic"}),
    ("SMALL supercell", "engine", SMALL[:4], {}, {}),
    ("DistMesh NCCL supercell D=1", "dist", SMALL[:4], {"n_shards": 1}, {}),
    ("DistMesh NCCL bands D=1", "dist", UNEVEN, {"n_shards": 1}, {}),
)
# The wrappers of the mesh monopole pass whose calls phase bf records: the
# resident meshes', the band meshes' and the super-cell engines'.
BF_MONOPOLE_WRAPPERS = ("tile_monopole_integrate",
                        "gathered_monopole_integrate",
                        "supercell_monopole_integrate")


def _exact(a, b):
    """Two tensors' values bit for bit, floats of any width by their bit
    patterns."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.contiguous().view(ints[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


def _clone_tree(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


@contextlib.contextmanager
def _recording(module, name, keep):
    """Within the block, ``module.name`` records copies of the arguments
    (args, kwargs) of its first ``keep`` calls, taken before each call
    (the wrappers write in place), into the list it yields."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kw):
        if len(calls) < keep:
            calls.append(_clone_tree((args, kw)))
        return real(*args, **kw)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _pack_bytes(dst, valid, take):
    """What a pack needs: the valid and take flags read once, and each
    landed entry's fields read from the buffer and written to its slot
    with its valid flag."""
    n_arr = take.sum(1)
    landed = int(torch.minimum(n_arr, (~valid).sum(1)).sum())
    row = sum(t.element_size() for t in dst.values())
    return valid.numel() + take.numel() + landed * (2 * row + 1)


def _compact_bytes(fields, emig, bcap):
    """What a compact needs: the emig flags read once, each emigrant's
    fields that land (the first B of a row's) read and written, the B
    valid flags of a row and its overflow count written. The entries past
    the emigrants are not read by any caller: their fields count for
    nothing."""
    B = min(bcap, emig.shape[1])
    landed = int(torch.clamp(emig.sum(1), max=B).sum())
    row = sum(t.element_size() for t in fields.values())
    return (emig.numel() + landed * 2 * row
            + emig.shape[0] * (B + 4))


def _monopole_mesh_bound(f, row_start, index, binned):
    """What the mesh monopole + integrate needs: a live slot (m != 0) reads
    m, mf, fxd, fyd, x, y, vx, vy and writes x, y, vx, vy (48 bytes), a
    frozen one reads m (4); the binned flag of a live slot where given;
    the row index (8 bytes, where given: else the row is its own) and the
    24 table words of each row (``row_start``) with a live slot, once;
    ~150 f32 operations and 8 rsqrt a live slot."""
    live_mask = f["m"].reshape(-1) != 0
    live = int(live_mask.sum())
    nbytes = 48 * live + 4 * (live_mask.numel() - live)
    if binned is not None:
        nbytes += live
    cum = torch.cat([live_mask.new_zeros(1, dtype=torch.int64),
                     torch.cumsum(live_mask, 0)])
    used = int((cum[row_start[1:]] > cum[row_start[:-1]]).sum())
    nbytes += 8 * used if index is not None else 0
    return _bound(nbytes + 96 * used, 150 * live, 8 * live)


def check_pack(tag, args, timed=False):
    """(bf) The pack kernel against the plain version on the card, each on
    its own copy of the slab: every field and valid bit for bit, the
    overflow exact; with ``timed``, the record and its bound."""
    from particlesimulation_tpu_torch.ops.cuda import migrate

    dst, valid, src, take = args

    def fresh():
        return ({k: v.clone() for k, v in dst.items()}, valid.clone(), src,
                take)

    def kernel(a):
        return migrate.pack(*a)

    def plain(a):
        return migrate.pack_ref(*a)

    got, ref = kernel(fresh()), plain(fresh())
    bad = [k for k in dst if not _exact(got[0][k], ref[0][k])]
    bad += [n for n, i in (("valid", 1), ("overflow", 2))
            if not _exact(got[i], ref[i])]
    if bad:
        raise AssertionError(f"{tag}: the pack differs from the plain "
                             f"version in {bad}")
    n_arr = int(take.sum())
    print(f"{tag}: pack bit for bit the plain version ({len(dst)} fields, "
          f"{tuple(valid.shape)} slab, {tuple(take.shape)} buffer, {n_arr} "
          f"arrivals, overflow {got[2].tolist()})", flush=True)
    rec = {"max_abs_err": 0.0, "library_ms": None}
    if timed:
        rec.update(_kernel_times(kernel, plain, fresh))
        _record(rec, _bound(_pack_bytes(dst, valid, take), 0, 0))
        print(f"{tag}: pack {rec['ms']:.4f} ms a call, {rec['device_ms']:.4f}"
              f" device (bound {rec['bound_ms']:.4f}, {rec['bound_by']}); "
              f"plain {rec['plain_ms']:.4f}", flush=True)
    return rec


def check_compact(tag, args, timed=False):
    """(bf) The emigrant buffer kernel against the plain version on the
    card: the valid flag of every entry and every field of the valid
    entries bit for bit, the overflow exact (the kernel does not write the
    fields of the entries past the emigrants, which no caller reads); with
    ``timed``, the record and its bound."""
    from particlesimulation_tpu_torch.ops.cuda import migrate

    (slab, emig, bcap), extra = args

    def kernel():
        return migrate.compact(slab, emig, bcap, **extra)

    def plain():
        return migrate.compact_ref(slab, emig, bcap, **extra)

    got, ref = kernel(), plain()
    ok = ref[0]["valid"]
    bad = [k for k in ref[0] if not (
        _exact(got[0][k], ref[0][k]) if k == "valid"
        else _exact(got[0][k][ok], ref[0][k][ok]))]
    if not _exact(got[1], ref[1]):
        bad.append("overflow")
    if bad or list(got[0]) != list(ref[0]):
        raise AssertionError(f"{tag}: the emigrant buffer differs from the "
                             f"plain version in {bad}")
    print(f"{tag}: compact bit for bit the plain version on the valid "
          f"entries and flags "
          f"({len(slab) + len(extra)} fields, {tuple(emig.shape)} slab, "
          f"bcap {bcap}, {int(emig.sum())} emigrants, overflow "
          f"{got[1].tolist()})", flush=True)
    rec = {"max_abs_err": 0.0, "library_ms": None}
    if timed:
        rec.update(_kernel_times(kernel, plain))
        _record(rec, _bound(_compact_bytes({**slab, **extra}, emig, bcap),
                            0, 0))
        print(f"{tag}: compact {rec['ms']:.4f} ms a call, "
              f"{rec['device_ms']:.4f} device (bound {rec['bound_ms']:.4f}, "
              f"{rec['bound_by']}); plain {rec['plain_ms']:.4f}", flush=True)
    return rec


def _monopole_super_bound(f, cell, sums, lines):
    """What the super-cell monopole + integrate needs: 48 bytes a live slot
    and 4 a frozen one (as the mesh pass), each live slot's cell index, the
    sums (12 bytes a cell) and the halo lines once; ~150 f32 operations and
    8 rsqrt a live slot. No table is read or written."""
    live_mask = f["m"].reshape(-1) != 0
    live = int(live_mask.sum())
    nbytes = (48 * live + 4 * (live_mask.numel() - live)
              + cell.element_size() * live + _nbytes(*sums)
              + (_nbytes(*lines[:2]) if lines is not None else 0))
    return _bound(nbytes, 150 * live, 8 * live)


def _tables_call(sums, side, nc, kw):
    """The stencil tables kernel (``stencil_grid`` / ``stencil_halo``) on a
    super-cell call's sums, as a callable: the tables the super-cell pass
    no longer builds."""
    from particlesimulation_tpu_torch.ops.cuda import stencil as st

    layout = kw.get("layout")
    if layout is None:
        return lambda: st.grid_tables(*sums, side, nc, from_sums=True)
    L, R = layout.row0[0].shape[0], layout.rows[0]
    grids = [tuple(a.view(L, R, nc) for a in sums)]
    return lambda: st.halo_tables(grids, layout, kw["lines"], side, nc,
                                  from_sums=True)


def check_mesh_monopole(tag, fn_name, args, kw, timed=False):
    """(bf) The mesh monopole + integrate kernels (``fn_name``:
    ``tile_monopole_integrate`` or ``gathered_monopole_integrate``, the
    resident and band meshes' rows; or ``supercell_monopole_integrate``,
    the super-cell routes' pass from the cell sums) against the plain
    version on the card, each on its own copy of x, y, vx, vy: every
    output bit for bit. With ``timed``, the record and its bound (timed on
    one copy, updated in place call after call: the same work each call,
    the frozen slots staying frozen) and, for the super-cells, the tables
    kernel (``stencil_grid`` / ``stencil_halo``) on the same sums."""
    from particlesimulation_tpu_torch.ops.cuda import advance as adv

    fields = dict(zip(("x", "y", "vx", "vy", "m", "mf", "fxd", "fyd"),
                      args[:8]))
    rest = args[8:]
    fn, ref_fn = getattr(adv, fn_name), getattr(adv, fn_name + "_ref")
    sc = fn_name == "supercell_monopole_integrate"

    def fresh():
        return tuple(fields[k].clone() for k in ("x", "y", "vx", "vy"))

    def kernel(xyv):
        return fn(*xyv, *args[4:8], *rest, **kw)

    def plain(xyv):
        return ref_fn(*xyv, *args[4:8], *rest, **kw)

    ref = plain(fresh())
    got = kernel(fresh())
    bad = {k: int((a.view(torch.int32) != b.view(torch.int32)).sum())
           for k, a, b in zip(("x", "y", "vx", "vy"), got, ref)
           if not _exact(a, b)}
    if bad:
        raise AssertionError(f"{tag}: {fn_name} differs from the plain "
                             f"chain in {bad} slots")
    live = int((fields["m"] != 0).sum())
    finite = [bool(torch.isfinite(a).all()) for a in got]
    print(f"{tag}: {fn_name} bit for bit the plain chain on "
          f"{fields['x'].numel()} slots ({live} live; all finite: "
          f"{all(finite)})", flush=True)
    rec = {"library_ms": None,
           "max_abs_err": max(_max_diff(a[torch.isfinite(a)],
                                        b[torch.isfinite(b)])
                              for a, b in zip(got, ref))}
    if not timed:
        return rec
    one = fresh()
    rec.update({"ms": _timed(lambda: kernel(one), 20),
                "device_ms": device_ms(lambda: kernel(one), 20),
                "plain_ms": _timed(lambda: plain(one), 3)})
    tables_txt = ""
    if sc:
        _record(rec, _monopole_super_bound(fields, rest[1], rest[0],
                                           kw.get("lines")))
        rec["tables_device_ms"] = device_ms(
            _tables_call(rest[0], rest[2], rest[3], kw), 20)
        tables_txt = (f"; the tables kernel on the same sums "
                      f"{rec['tables_device_ms']:.4f}")
    elif fn_name == "tile_monopole_integrate":
        _record(rec, _monopole_mesh_bound(fields, rest[1], None, None))
    else:
        _record(rec, _monopole_mesh_bound(
            fields, adv.row_starts(rest[4], one[0].device), rest[1],
            kw.get("binned")))
    print(f"{tag}: {fn_name} {rec['ms']:.4f} ms a call, "
          f"{rec['device_ms']:.4f} device (bound {rec['bound_ms']:.4f}, "
          f"{rec['bound_by']}; {live} live slots){tables_txt}; plain chain "
          f"{rec['plain_ms']:.4f}", flush=True)
    return rec


def _adversarial_mesh_calls(dev):
    """The adversarial inputs of phase bf on ``dev``: (pack cases, compact
    cases, monopole calls [(tag, wrapper, args, kwargs)])."""
    adv = _adversarial_module()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    packs = {name: ({k: t(v) for k, v in d.items()}, t(v),
                    {k: t(x) for k, x in s.items()}, t(tk))
             for name, (d, v, s, tk) in adv.pack_cases().items()}
    compacts = {name: ((({k: t(v) for k, v in sl.items()}, t(e), b),
                        {k: t(v) for k, v in ex.items()}))
                for name, (sl, e, b, ex) in adv.compact_cases().items()}
    from particlesimulation_tpu_torch.config import DELTAT
    from particlesimulation_tpu_torch.ops.cuda import advance
    from particlesimulation_tpu_torch.ops.cuda import stencil as st

    names = ("x", "y", "vx", "vy", "m", "mf", "fxd", "fyd")
    c = adv.mesh_monopole_case()
    f = [t(c[k]) for k in names]
    side = c["side"]
    tile = tuple(t(a) for a in c["tile"])
    gath = tuple(t(a) for a in c["gathered"])
    binned = t(c["binned"])
    pool_rs = t(c["pool_row_start"])
    monos = [
        ("tile", "tile_monopole_integrate",
         (*f, tile, t(c["row_start"]), side, DELTAT), {}),
        ("rows", "gathered_monopole_integrate",
         (*f, gath, t(c["row_index"]), side, DELTAT,
          ((25, f[0].shape[1]),)), {"binned": binned}),
        ("pool rows", "gathered_monopole_integrate",
         (*f, gath, t(c["pool_row_index"]), side, DELTAT,
          tuple((n, w) for _, n, w in advance._segments(pool_rs))),
         {"binned": binned}),
    ]
    for rc in adv.row_monopole_cases():
        f = [t(rc[k]) for k in names]
        rows = (t(rc["row_start"]), t(rc["row_index"]))
        monos.append((rc["name"], "gathered_monopole_integrate",
                      (*f, tuple(t(a) for a in rc["gathered"]), rows[1],
                       rc["side"], DELTAT, rc["runs"]),
                      {"binned": t(rc["binned"])}))
        if rc["tile"] is not None:
            (nrows, K), = rc["runs"]
            monos.append((f"{rc['name']}, row tables",
                          "tile_monopole_integrate",
                          (*(a.view(nrows, K) for a in f),
                           tuple(t(a) for a in rc["tile"]), rows[0],
                           rc["side"], DELTAT), {}))
    for sc in adv.supercell_monopole_cases():
        f = [t(sc[k]) for k in names]
        kw = {}
        if sc["mesh"] is not None:
            m = sc["mesh"]
            kw = {"layout": st.HaloLayout(
                (m["R"],), sc["nc"], row0=(t(m["row0"]),),
                rows_mine=(t(m["rows_mine"]),)),
                  "lines": (t(m["top"]), t(m["bot"]), None, None)}
        for dtype in (torch.int64, torch.int32):
            monos.append((f"{sc['name']} ({str(dtype)[6:]} cells)",
                          "supercell_monopole_integrate",
                          (*f, tuple(t(a) for a in sc["sums"]),
                           t(sc["cell"]).to(dtype), sc["side"], sc["nc"],
                           DELTAT, sc["S"]), kw))
    return packs, compacts, monos


def check_mesh_kernels(card):
    """(bf) The migration pack (``pack``, ``compact``) and the mesh
    monopole + integrate kernels (the resident and band meshes' rows, the
    super-cell routes' pass from the cell sums in both forms) against
    their plain versions on the card, bit for bit: on
    ``ops/cuda/adversarial``'s cases (``pack_cases``, ``compact_cases``,
    ``mesh_monopole_case`` in both forms and row modes,
    ``row_monopole_cases``, ``supercell_monopole_cases`` with int64 and
    int32 cells), on every migration call of the first step of the parity
    meshes at D = 2, 4 and (2, 2) (golden s1; their own slabs and buffers,
    recorded from an eager run), and on the monopole + integrate call of
    the first step of the six tile engines at their paths' sizes (the
    flagship's mesh at D = 4 and on (2, 2), SMALL's mesh super-cells at D =
    4, UNEVEN's column and cyclic bands at D = 4, single-device SMALL) and
    of the ``DistMesh`` NCCL D = 1 super-cell and band paths; the engines'
    calls timed (ms, device ms) against their bounds, the super-cells'
    beside the tables kernel on the same sums. Returns {"migrate_pack": record, "monopole_gathered": record,
    "monopole_supercell": record} (the flagship parity mesh at D = 2's
    pack, the flagship fast mesh's rows, SMALL's super-cell pass)."""
    from particlesimulation_tpu_torch.ops import graphed
    from particlesimulation_tpu_torch.ops.cuda import advance as adv
    from particlesimulation_tpu_torch.ops.cuda import migrate

    t0 = time.perf_counter()
    packs, compacts, monos = _adversarial_mesh_calls("cuda")
    for name, a in packs.items():
        check_pack(f"adversarial pack, {name}", a)
    for name, a in compacts.items():
        check_compact(f"adversarial compact, {name}", a)
    for name, fn, a, kw in monos:
        check_mesh_monopole(f"adversarial monopole, {name}", fn, a, kw)
    del packs, compacts, monos
    recs = {}
    for label, kind, args, cfg_kw, eng_kw in BF_PACK_PATHS:
        eng, state = _graph_engine(kind, args, cfg_kw, eng_kw)
        with _recording(migrate, "pack", 8) as packs, _recording(
                migrate, "compact", 1) as compacts:
            eng.run_eager(state, 1)
        torch.cuda.synchronize()
        if not packs or not compacts:
            raise AssertionError(f"{label}: no migration call recorded")
        for i, (a, kw) in enumerate(packs):
            r = check_pack(f"{label}, its pack {i}", a, timed=i == 0)
            if i == 0:
                pack_rec = r
        (a, kw), = compacts
        crec = check_compact(f"{label}, its emigrant buffer",
                             ((a[0], a[1], a[2]), kw), timed=True)
        recs.setdefault("migrate_pack", {**pack_rec,
                                         "compact_device_ms":
                                             crec["device_ms"]})
        graphed.release(_target(eng)._run)
        del eng, state, packs, compacts
        torch.cuda.empty_cache()
    for label, kind, args, cfg_kw, eng_kw in BF_MONOPOLE_PATHS:
        eng, state = _graph_engine(kind, args, cfg_kw, eng_kw)
        with contextlib.ExitStack() as stack:
            recorded = [(name, stack.enter_context(_recording(adv, name, 1)))
                        for name in BF_MONOPOLE_WRAPPERS]
            eng.run_eager(state, 1)
        torch.cuda.synchronize()
        calls = [(name, c) for name, got in recorded for c in got]
        if len(calls) != 1:
            raise AssertionError(f"{label}: {len(calls)} monopole calls "
                                 f"recorded, not 1")
        fn, (a, kw) = calls[0]
        r = check_mesh_monopole(f"{label} ({_target(eng).impl})", fn, a, kw,
                                timed=True)
        recs.setdefault("monopole_supercell" if fn.startswith("supercell")
                        else "monopole_gathered", r)
        graphed.release(_target(eng)._run)
        del eng, state, calls, recorded
        torch.cuda.empty_cache()
    print(f"the mesh kernels (bf): {time.perf_counter() - t0:.1f} s on "
          f"{card}", flush=True)
    return recs


# Phase bg: the stencil tables' kernels (ops/cuda/stencil, csrc/stencil.cu)
# on the adversarial layouts and on the tables inputs of an eager step of
# every route that builds tables.
BG_PATHS = (
    ("parity s1", "engine", GOLDEN_S1[:4], {"precision": "parity"}, {}),
    ("MEDIUM f64", "engine", MEDIUM[:4], {"precision": "parity"}, {}),
    ("dense flagship", "engine", GOLDEN_S1[:4], {}, {"impl": "dense"}),
    ("UNEVEN tiered", "engine", UNEVEN, {}, {"impl": "tiered"}),
    ("mesh parity D=2", "mesh", GOLDEN_S1[:4],
     {"n_shards": 2, "precision": "parity"}, {}),
    ("mesh parity D=4", "mesh", GOLDEN_S1[:4],
     {"n_shards": 4, "precision": "parity"}, {}),
    ("2D parity (2, 2)", "mesh2d", GOLDEN_S1[:4],
     {"n_shards": 4, "mesh_shape": (2, 2), "precision": "parity"}, {}),
    ("mesh fast D=4", "mesh", GOLDEN_S1[:4], {"n_shards": 4}, {}),
    ("2D (2, 2)", "mesh2d", GOLDEN_S1[:4],
     {"n_shards": 4, "mesh_shape": (2, 2)}, {}),
    ("column bands D=4", "mesh", UNEVEN, {"n_shards": 4}, {}),
    ("cyclic D=4", "mesh", UNEVEN, {"n_shards": 4},
     {"impl": "banded-cyclic"}),
)
# The records of the kernels line: parity s1's grid (the CLI's default
# route), the fast mesh's halo. (The super-cell routes build no tables: bf
# times the tables kernel on their sums beside their pass.)
BG_RECORDS = {"stencil_grid": "parity s1",
              "stencil_halo": "mesh fast D=4"}


def _stencil_module():
    """``ops/cuda/stencil`` (a parent checkout without it, timed by
    ``--mesh-times``: None)."""
    try:
        from particlesimulation_tpu_torch.ops.cuda import stencil
    except ImportError:
        return None
    return stencil


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _stencil_bound(nbytes, cells, from_sums, dtype):
    """A tables call's bound: its bytes (each input read once, each output
    written once) against its operations (16 additions a cell, and 16
    divisions from the sums) at the dtype's peak."""
    ops = 16 * cells * (2 if from_sums else 1)
    mem_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = ops / (PEAK_F64 if dtype == torch.float64 else PEAK_F32) * 1e3
    return (max(mem_ms, ops_ms), "bytes" if mem_ms >= ops_ms
            else "operations", 0.0)


def _same_tables(tag, got, ref):
    """Fail unless every table of ``got`` is ``ref``'s, bit for bit."""
    bad = [i for i, (a, b) in enumerate(zip(got, ref)) if not _exact(a, b)]
    if bad or len(got) != len(ref):
        diff = {i: int((got[i] != ref[i]).sum()) for i in bad}
        raise AssertionError(f"{tag}: tables {bad} differ from the plain "
                             f"version ({diff} entries)")


def _grid_gather(a, b, c, ncside):
    """The one-device tables' library call: the plain version's gather
    ``v[:, idx]`` of the three grids by its plan, alone (v, idx)."""
    from particlesimulation_tpu_torch.ops import stencil

    idx, _ = stencil._stencil_plan(1.0, ncside, a.dtype, a.device)
    z = a.new_zeros(1)
    return torch.cat([a, z, b, z, c, z]).view(3, -1), idx


def _halo_gather(st, grids, layout, lines, side, nc):
    """A mesh's tables as one gather ``v[:, idx]``: v every source (a 0,
    the grids, the received lines) a field, idx each table entry's source,
    read off the plain version's mass table run on the sources' own
    indices (in f64, exact)."""
    dev = grids[0][0].device
    parts = [torch.zeros(3, 1, dtype=grids[0][0].dtype, device=dev)]
    at, ig, il = 1, [], []
    for gb in grids:
        parts.append(torch.stack(gb).reshape(3, -1))
        n = gb[0].numel()
        ig.append((torch.arange(at, at + n, dtype=torch.float64, device=dev)
                   .view(gb[0].shape),) * 3)
        at += n
    for t in lines:
        if t is None:
            il.append(None)
            continue
        L, B, _, n = t.shape
        parts.append(t.transpose(0, 2).reshape(3, -1))
        il.append((at + torch.arange(B * L * n, dtype=torch.float64,
                                     device=dev).view(B, L, n))
                  .transpose(0, 1)[:, :, None, :].expand(L, B, 3, n)
                  .contiguous())
        at += B * L * n
    idx = st.halo_tables_ref(ig, layout, il, 0.0, nc)[0]
    return torch.cat(parts, dim=1), idx.to(torch.int64)


def _library_times(v, idx):
    return {"library_ms": _timed(lambda: v[:, idx], 20),
            "library_device_ms": device_ms(lambda: v[:, idx], 20)}


def _launch_rows(fn):
    """{kernel name: launches} of one profiled call of ``fn``."""
    rows = {}
    for _, n, name in _profile_fn(fn):
        if n:
            rows[name] = rows.get(name, 0) + n
    return rows


def _stencil_profile(tag, fn, want, exchange=None):
    """Profile one call: fail unless it launches the stencil kernels of
    ``want`` ({name: launches}) and nothing else but what ``exchange`` (the
    plain exchange alone, which launches no stencil kernel) launches,
    kernel for kernel. Returns the other launches."""
    got, others = {}, {}
    for name, n in _launch_rows(fn).items():
        hit = [k for k in STENCIL_KERNELS if f"{k}_kernel" in name]
        if hit:
            got[hit[0]] = got.get(hit[0], 0) + n
        else:
            others[name] = n
    plain = _launch_rows(exchange) if exchange is not None else {}
    if any(k in name for name in plain for k in STENCIL_KERNELS):
        raise AssertionError(f"{tag}: the exchange launched a stencil "
                             f"kernel: {plain}")
    if got != want or others != plain:
        raise AssertionError(f"{tag}: the tables phase launched {got} and "
                             f"{others}, not {want} and the exchange's "
                             f"{plain}")
    return sum(others.values())


def check_stencil_grid(tag, args, kw, timed=False):
    """(bg) The one-device tables kernel against its plain version on the
    card, bit for bit; with ``timed``, the record (its bound, the plain
    gather alone as the library call) and the profile of one call."""
    st = _stencil_module()
    a, b, c, side, nc = args

    def kernel():
        return st.grid_tables(a, b, c, side, nc, **kw)

    def plain():
        return st.grid_tables_ref(a, b, c, side, nc, **kw)

    got = kernel()
    _same_tables(tag, got, plain())
    rec = {"max_abs_err": 0.0, "library_ms": None}
    if not timed:
        return rec
    rec.update(_kernel_times(kernel, plain))
    _record(rec, _stencil_bound(_nbytes(a, b, c, *got), nc * nc,
                                kw.get("from_sums", False), a.dtype))
    rec.update(_library_times(*_grid_gather(a, b, c, nc)))
    _stencil_profile(tag, kernel, {"stencil_grid": 1})
    print(f"{tag}: stencil_grid bit for bit ({nc * nc} cells, {a.dtype}, "
          f"{kw}); {rec['ms']:.4f} ms a call, {rec['device_ms']:.4f} device "
          f"(bound {rec['bound_ms']:.4f}, {rec['bound_by']}); plain "
          f"{rec['plain_ms']:.4f}; the gather alone {rec['library_ms']:.4f}, "
          f"{rec['library_device_ms']:.4f} device", flush=True)
    return rec


def check_stencil_mesh(tag, args, kw, timed=False):
    """(bg) A mesh route's tables kernel against its plain version on the
    card, bit for bit, on the lines the plain exchange delivered; with
    ``timed``, its record (bound; the plain gather alone as the library
    call) and the profile of one whole tables phase: the tables kernel once
    for each 32 bands, and what the exchange alone launches. A layout of
    more than 32 bands is profiled untimed too."""
    st = _stencil_module()
    mesh, layout, grids, side, nc = args
    fs = kw.get("from_sums", False)
    lines = st.exchange(mesh, layout, grids)

    def kernel():
        return st.halo_tables(grids, layout, lines, side, nc, fs)

    def plain():
        return st.halo_tables_ref(grids, layout, lines, side, nc, fs)

    out = kernel()
    _same_tables(tag, out, plain())
    want = {"stencil_halo": -(-len(grids) // STENCIL_BANDS)}
    if not timed:
        if len(grids) > STENCIL_BANDS:
            _stencil_profile(tag, kernel, want)
            print(f"{tag}: {len(grids)} bands, stencil_halo launched "
                  f"{want['stencil_halo']}x", flush=True)
        return {}
    like = grids[0][0]
    rec = {"max_abs_err": 0.0}
    rec.update(_kernel_times(kernel, plain))
    _record(rec, _stencil_bound(
        _nbytes(*(t for gb in grids for t in gb), *lines, *out),
        layout.cells, fs, like.dtype))
    rec.update(_library_times(*_halo_gather(st, grids, layout, lines, side,
                                            nc)))
    sent = _stencil_profile(tag, lambda: st.mesh_tables(*args, **kw), want,
                            lambda: st.exchange(mesh, layout, grids))
    print(f"{tag}: stencil_halo bit for bit ({layout.cells} cells in "
          f"{len(grids)} band(s), {like.dtype}, from sums {fs}, aligned "
          f"{layout.aligned}); {rec['ms']:.4f} ms a call, "
          f"{rec['device_ms']:.4f} device (bound {rec['bound_ms']:.4f}, "
          f"{rec['bound_by']}); plain {rec['plain_ms']:.4f}; the gather "
          f"alone {rec['library_ms']:.4f}, {rec['library_device_ms']:.4f} "
          f"device; the phase launches the tables "
          f"{want['stencil_halo']}x and the exchange's {sent} launches",
          flush=True)
    return {"stencil_halo": rec}


def check_stencil(card):
    """(bg) The stencil tables' kernels against their plain versions on the
    card, bit for bit: on ``adversarial.stencil_cases`` (one device at nc
    = 1, 2, 3, 5, 100 in both layouts; every halo layout of the meshes) in
    f32 and f64, from the COM and from the sums; and on the tables inputs
    of an eager step of every route that builds tables (BG_PATHS: parity
    s1, MEDIUM f64, SMALL (1.69 M cells), dense, tiered UNEVEN, the parity
    meshes at D = 2, 4 and (2, 2), the fast mesh at D = 4 and (2, 2),
    SMALL's mesh super-cells, UNEVEN's column and cyclic bands), each
    timed against its byte bound and beside the plain gather ``v[:, idx]``
    alone, and its tables phase profiled: the tables kernel once a call
    (once for each 32 bands), and nothing else but the plain exchange's
    launches.
    Returns the kernels line's records (BG_RECORDS)."""
    from particlesimulation_tpu_torch.ops import graphed

    st = _stencil_module()
    adv = _adversarial_module()
    t0 = time.perf_counter()
    n = 0
    for case in adv.stencil_cases():
        for dtype in (torch.float32, torch.float64):
            for fs in (False, True):
                if case["kind"] == "grid":
                    a, b, c = (torch.from_numpy(x).to(dtype).cuda()
                               for x in case["grid"])
                    for aligned in (False, True):
                        check_stencil_grid(
                            f"adversarial {case['name']}",
                            (a, b, c, case["side"], case["nc"]),
                            {"from_sums": fs, "aligned": aligned})
                        n += 1
                    continue
                mesh, layout, grids = adv.stencil_inputs(case, dtype, "cuda")
                check_stencil_mesh(f"adversarial {case['name']}",
                                   (mesh, layout, grids, case["side"],
                                    case["nc"]), {"from_sums": fs})
                n += 1
    print(f"bg: {n} adversarial tables bit for bit the plain versions "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    recs = {}
    for label, kind, args, cfg_kw, eng_kw in BG_PATHS:
        eng, state = _graph_engine(kind, args, cfg_kw, eng_kw)
        with _recording(st, "grid_tables", 1) as grid, _recording(
                st, "mesh_tables", 1) as meshes:
            eng.run_eager(state, 1)
        torch.cuda.synchronize()
        if len(grid) + len(meshes) != 1:
            raise AssertionError(f"{label}: {len(grid)} grid and "
                                 f"{len(meshes)} mesh tables calls recorded")
        tag = f"{label} ({_target(eng).impl})"
        if grid:
            (a, kw), = grid
            r = {"stencil_grid": check_stencil_grid(tag, a, kw, timed=True)}
        else:
            (a, kw), = meshes
            r = check_stencil_mesh(tag, a, kw, timed=True)
        for k, rec in r.items():
            if BG_RECORDS[k] == label:
                recs[k] = rec
        graphed.release(_target(eng)._run)
        del eng, state, grid, meshes
        torch.cuda.empty_cache()
    print(f"the stencil kernels (bg): {time.perf_counter() - t0:.1f} s on "
          f"{card}", flush=True)
    return recs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    if sys.argv[1:2] == ["--mesh-times"]:
        # Checkouts in turns (e.g. parent, change, change, parent), each in
        # a process of its own that imports that checkout's package.
        times_of_all(sys.argv[2:], "mesh")
        return
    if sys.argv[1:2] == ["--mesh-times-of"]:
        flagship_mesh_times(sys.argv[2])
        return
    if sys.argv[1:2] == ["--direct-times"]:
        # Checkouts in turns, a process each, as --mesh-times.
        for root in sys.argv[2:]:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--direct-times-of", root], cwd=ROOT, check=True)
        return
    if sys.argv[1:2] == ["--direct-times-of"]:
        direct_times(sys.argv[2])
        return
    if sys.argv[1:2] == ["--supercell"]:
        # Phases h-l alone.
        card = _card()
        print(card, flush=True)
        build_libraries()
        sub_rec, sums_rec, launches, _ = check_small(card)
        print(json.dumps({"kernels": [
            kernel_entry("fused_pairs_sub", launches["fused_pairs_sub"],
                         sub_rec),
            kernel_entry("supercell_cell_sums",
                         launches["supercell_cell_sums"], sums_rec)]}))
        return
    if sys.argv[1:2] == ["--supercell-times"]:
        supercell_times_of_all(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--supercell-times-of"]:
        supercell_times(sys.argv[2])
        return
    if sys.argv[1:2] == ["--advance"]:
        # Phases ar-at alone, and the two paths they serve.
        card = _card()
        print(card, flush=True)
        build_libraries()
        recs = check_advance(card)
        launches = check_advance_paths()
        print(json.dumps({"kernels": [
            kernel_entry(k, launches[k], recs[k], ADVANCE_SOURCE)
            for k in ADVANCE_KERNELS]}))
        return
    if sys.argv[1:2] == ["--advance-times"]:
        times_of_all(sys.argv[2:], "advance")
        return
    if sys.argv[1:2] == ["--settle-sweep"]:
        print(_card(), flush=True)
        build_libraries()
        settle_sweep()
        return
    if sys.argv[1:2] == ["--advance-times-of"]:
        advance_times(sys.argv[2])
        return
    if sys.argv[1:2] == ["--mesh2d"]:
        # Phases ae-ak alone.
        card = _card()
        print(card, flush=True)
        check_mesh2d(card)
        return
    if sys.argv[1:2] == ["--wide"]:
        # Phases av-ay alone (MEDIUM's f32 sweep not run).
        card = _card()
        print(card, flush=True)
        build_libraries()
        recs, launches = check_wide(card, None)
        print(json.dumps({"kernels": [
            kernel_entry(k, launches[k if k != "dense_pairwise_forces"
                                     else "dense_forces"], rec)
            for k, rec in recs.items()]}))
        return
    if sys.argv[1:2] == ["--sweep"]:
        # The sweep's phases alone: (a)-(g), then az-ba.
        card = _card()
        print(card, flush=True)
        build_libraries()
        check_cli_parity()
        check_cli_parity_inprocess()
        check_parity_golden()
        check_parity_card_vs_cpu()
        check_f32_sweep()
        medium = check_medium()
        check_cli_fast()
        time_sweeps(card, medium)
        recs = check_sweep(card)
        print(json.dumps({"kernels": sweep_entries(recs)}))
        return
    if sys.argv[1:2] == ["--sweep-com"]:
        # The COM kernel's checks and times alone (az without the forces
        # and collisions).
        card = _card()
        print(card, flush=True)
        build_libraries()
        recs = check_sweep_kernels(card, com_only=True)
        print(json.dumps({"kernels": [kernel_entry(
            "sweep_com", 0, recs["sweep_com"], SWEEP_SOURCE)]}))
        return
    if sys.argv[1:2] == ["--golden-long"]:
        # The four long-horizon golden vectors, recorded whatever they give.
        print(_card(), flush=True)
        build_libraries()
        run_golden(LONG_GOLDEN, required=False)
        return
    if sys.argv[1:2] == ["--sweep-times"]:
        times_of_all(sys.argv[2:], "sweep")
        return
    if sys.argv[1:2] == ["--sweep-times-of"]:
        sweep_times(sys.argv[2])
        return
    if sys.argv[1:2] == ["--graphs"]:
        # Phase bc alone.
        card = _card()
        print(card, flush=True)
        build_libraries()
        check_graphs(card)
        return
    if sys.argv[1:2] == ["--mesh-kernels"]:
        # Phase bf alone.
        card = _card()
        print(card, flush=True)
        build_libraries()
        recs = check_mesh_kernels(card)
        print(json.dumps({"kernels": [
            kernel_entry("migrate_pack", 0, recs["migrate_pack"],
                         MIGRATE_SOURCE),
            *(kernel_entry(k, 0, recs[k], ADVANCE_SOURCE)
              for k in ("monopole_gathered", "monopole_supercell"))]}))
        return
    if sys.argv[1:2] == ["--stencil"]:
        # Phase bg alone.
        card = _card()
        print(card, flush=True)
        build_libraries()
        recs = check_stencil(card)
        print(json.dumps({"kernels": [
            kernel_entry(k, 0, recs[k], STENCIL_SOURCE)
            for k in STENCIL_KERNELS]}))
        return
    if sys.argv[1:2] == ["--dist"]:
        # Phase be alone.
        card = _card()
        print(card, flush=True)
        build_libraries()
        check_dist(card)
        return
    if sys.argv[1:2] == ["--com-back-to-back"]:
        # Phase bd alone.
        card = _card()
        print(card, flush=True)
        build_libraries()
        check_com_back_to_back(card)
        return
    if sys.argv[1:2] == ["--direct"]:
        # Phases al-aq alone.
        card = _card()
        print(card, flush=True)
        build_libraries()
        launches, recs = check_direct(card)
        print(json.dumps({"kernels": [
            kernel_entry(k, launches[k], recs[k], DIRECT_SOURCE)
            for k in recs]}))
        return

    # 1. The card.
    card = _card()
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {name}", flush=True)

    # 2. Build the kernel library from the checkout's sources.
    from particlesimulation_tpu_torch.config import SimConfig
    from particlesimulation_tpu_torch.engine import (
        Engine, make_dense_step, make_resident_run)
    from particlesimulation_tpu_torch.ops.cuda.launch_sweep import (
        UNEVEN_PLAN, class_tiles, dense_tiles, resident_tiles)
    from particlesimulation_tpu_torch.ops import graphed
    from particlesimulation_tpu_torch.ops.tiered import make_tiered_step

    build_libraries()

    # 3. Each kernel vs its plain version: the flagship tile shape, kcap
    # 1024, kcap 288 (no power of two) and a tiered UNEVEN class shape; then
    # the adversarial tiles.
    shapes = ((10_000, 160, 100), (300, 1024, 900), (500, 288, 200))
    for ncells, kcap, fill in shapes:
        for form in ("v4", "v2"):
            for collide in (True, False):
                check_fused(ncells, kcap, fill, form, collide)
    forces, colls = {}, {}
    for ncells, kcap, fill in shapes + ((96, 864, 600),):
        check_fused(ncells, kcap, fill, "v2", True, gated=False)
        forces[ncells] = check_dense_forces(ncells, kcap, fill)
        for with_pid in (False, True):
            colls[(ncells, with_pid)] = check_dense_collisions(
                ncells, kcap, fill, with_pid)
    for kcap in (32, 160, 288, 1024):
        check_adversarial(kcap)
    # The kernels around the pair pass (phases ar-at), and the migration
    # pack and the mesh monopole + integrate (bf).
    adv_recs = check_advance(card)
    mesh_recs = check_mesh_kernels(card)
    # The stencil tables' kernels (bg).
    stencil_recs = check_stencil(card)

    seed, side, nc, n, steps, ex, ey, ec = GOLDEN_S1
    s1 = SimConfig(seed, side, nc, n)

    # 4. The resident path (the main path): golden s1, default pair kernel.
    eng = Engine(s1, device="cuda")
    state = eng.init_state()
    _, res_launches = check_golden("golden s1 resident", eng, state, steps,
                                   (ex, ey, ec),
                                   ["fused_pairs", *ADVANCE_KERNELS])
    check_no_sync("resident", make_resident_run(s1, eng.kcap)[2], state)
    check_advance_launches("resident flagship", _tile_phases(
        make_resident_run, s1, eng.kcap), state)
    check_step("resident flagship", eng, state, 12, exact=True)
    # The fused kernel on the tiles the resident run hands its pair pass at
    # golden s1's last step, holes and limbo slots included.
    tiles = resident_tiles(s1, eng.kcap, state, steps)
    on_path = {kind: fused_record("resident flagship tiles", tiles, *kind,
                                  planted=False)
               for kind in (("v4", True), ("v4", False), ("v2", True, False))}
    check_gpu_vs_cpu(1, 5000.0, 32, 20_000, 10)
    check_gpu_vs_cpu(2, 100.0, 16, 12_000, 5)
    res_ms, t1, t101 = step_ms(eng, state, 100)
    print(f"resident flagship {n} particles, kcap {eng.kcap}: {res_ms:.4f} "
          f"ms/step, {n / res_ms / 1e3:.2f} M particle-steps/s (run(1) "
          f"{t1:.4f} s, run(101) {t101:.4f} s) on {card}", flush=True)
    device_breakdown("resident flagship", eng, state, res_ms)

    # 5. The resident path with the v1 pair kernel.
    eng_v1 = Engine(s1, device="cuda", impl="resident", pair_impl="v1")
    _, v1_launches = check_golden("golden s1 resident v1", eng_v1,
                                  eng_v1.init_state(), steps, (ex, ey, ec),
                                  ["fused_pairs_v1"])

    # 6. The dense path: golden s1.
    eng_d = Engine(s1, device="cuda", impl="dense")
    state_d = eng_d.init_state()
    _, dense_launches = check_golden(
        "golden s1 dense", eng_d, state_d, steps, (ex, ey, ec),
        ["dense_forces", "dense_collisions", "stencil_grid"])
    check_no_sync("dense", make_dense_step(s1, eng_d.kcap)[2], state_d)
    check_gpu_vs_cpu(2, 100.0, 16, 12_000, 5, impl="dense")
    dense_ms, t1, t101 = step_ms(eng_d, state_d, 100)
    print(f"dense flagship {n} particles, kcap {eng_d.kcap}: {dense_ms:.4f} "
          f"ms/step, {n / dense_ms / 1e3:.2f} M particle-steps/s (run(1) "
          f"{t1:.4f} s, run(101) {t101:.4f} s) on {card}", flush=True)
    device_breakdown("dense flagship", eng_d, state_d, dense_ms)
    tiles = make_dense_step(s1, eng_d.kcap)[1](state_d)
    check_tiles("dense flagship", [dense_tiles(s1, tiles)])

    # 7. The tiered path: UNEVEN, against the JAX result, then against the
    # dense engine on the card.
    un = SimConfig(*UNEVEN)
    eng_t = Engine(un, device="cuda", impl="tiered")
    state_t = eng_t.init_state()
    if tuple(map(tuple, eng_t._tier_plan)) != UNEVEN_PLAN:
        raise AssertionError(f"UNEVEN plan {eng_t._tier_plan}")
    _, tiered_launches = check_golden(
        "UNEVEN tiered", eng_t, state_t, 2, UNEVEN_2,
        ["dense_forces", "dense_collisions", "stencil_grid"])
    check_no_sync("tiered", make_tiered_step(un, UNEVEN_PLAN, "cuda")[2],
                  state_t)
    check_tiles("UNEVEN tiered", class_tiles(un, UNEVEN_PLAN, state_t))
    runs = []
    for impl in ("tiered", "dense"):
        e = Engine(un, device="cuda", impl=impl)
        out = e.run(e.init_state(), 10)
        if e.impl != impl or int(out.overflow) != 0:
            raise AssertionError(f"UNEVEN {impl}: ran {e.impl}, overflow "
                                 f"{int(out.overflow)}")
        runs.append((int(out.collisions), out, un.side))
    compare_runs("UNEVEN 10 steps, tiered vs dense on cuda", *runs, 2e-5,
                 None)
    check_gpu_vs_cpu(-7, 24.0, 12, 2000, 12, impl="tiered")
    eng_dun = Engine(un, device="cuda", impl="dense")
    state_dun = eng_dun.init_state()
    tiles = make_dense_step(un, eng_dun.kcap)[1](state_dun)
    check_tiles("UNEVEN dense", [dense_tiles(un, tiles)])
    for label, e, st in (("tiered", eng_t, state_t),
                         ("dense", eng_dun, state_dun)):
        ms, t1, t11 = step_ms(e, st, 10)
        print(f"UNEVEN {label}, kcap {e.kcap}: {ms:.4f} ms/step, "
              f"{n / ms / 1e3:.2f} M particle-steps/s (run(1) {t1:.4f} s, "
              f"run(11) {t11:.4f} s) on {card}", flush=True)
        device_breakdown(f"UNEVEN {label}", e, st, ms)
    # The tiered engine's graphs, captured here, are replayed and profiled
    # again in phase q, after the sweep and supercell phases' own graphs:
    # the result of that replay must be this one's, with no new capture.
    long_lived = (_state_bits(eng_t.run(state_t, 10)),
                  eng_t._run.graphs.captures)
    for e in (eng, eng_v1, eng_d):
        graphed.release(e._run)

    # 8. The sweep engine (f64 parity and f32) and the CLI.
    t_sweep = time.perf_counter()
    check_cli_parity()
    check_cli_parity_inprocess()
    check_parity_golden()
    check_parity_card_vs_cpu()
    check_f32_sweep()
    medium = check_medium()
    cli_launches = check_cli_fast()
    sweep_steps = time_sweeps(card, medium)
    print(f"sweep and CLI phases: {time.perf_counter() - t_sweep:.1f} s; "
          f"per step {json.dumps(sweep_steps)}", flush=True)
    # The sweep's kernels against their plain versions, timed (az), and the
    # heavy golden vectors through the default CLI (ba).
    sweep_recs = check_sweep(card)

    # 9. The supercell engine at SMALL.
    sub_rec, sums_rec, small_launches, small_cli = check_small(card)

    # 10. The banded engine: UNEVEN by the census, and N = 1e7 streaming,
    # beside phase 7's tiered and dense engines, their graphs replayed and
    # profiled a long while after their capture.
    check_long_lived("UNEVEN tiered", eng_t, state_t, 10, *long_lived)
    banded_launches, _ = check_banded(card, (eng_t, state_t),
                                      (eng_dun, state_dun))
    for e in (eng_t, eng_dun):
        graphed.release(e._run)
    del eng_t, eng_dun

    # 11. The 1D row mesh at the flagship on a local mesh of the card.
    mesh_launches, _ = check_mesh(card)

    # 12. The mesh census's other routes: super-cells (SMALL), column
    # bands (UNEVEN) and the streaming route (2e7).
    route_launches, _ = check_mesh_routes(card)

    # 13. The 2D mesh (the flagship, and the census's delegation under it)
    # and the block-cyclic bands (UNEVEN).
    mesh2d_launches, _ = check_mesh2d(card)

    # 14. The direct model (exact all-pairs), N = 1e5 its main path.
    direct_launches, direct_recs = check_direct(card)

    # 15. Tiles up to K = 4096 (phases av-ay): the kernels at K = 1056, 2048
    # and 4096, the kernels around the pair pass at 4096, and MEDIUM on
    # resident tiles under dense_backend="xla" and through --mesh 4.
    _, medium_launches = check_wide(card, medium[3])

    # 16. Every tile path's run as CUDA graphs against its eager run (bc),
    # and the COM kernel launched back to back on differing layouts (bd).
    check_graphs(card)
    check_com_back_to_back(card)

    # 17. The torch.distributed mesh (be): NCCL at world size 1 in this
    # process, gloo ranks sharing the card, NCCL across cards where there
    # are two.
    dist_launches = check_dist(card)

    print(f"launches per path: resident {res_launches}, resident v1 "
          f"{v1_launches}, dense {dense_launches}, tiered {tiered_launches}, "
          f"CLI fast {cli_launches}, supercell SMALL {small_launches}, CLI "
          f"fast SMALL {small_cli}, banded UNEVEN (2 steps: 13 fused "
          f"launches a step and 13 for the first pass) {banded_launches}, "
          f"mesh resident D=4 (golden s1) {mesh_launches}, "
          + ", ".join(f"{k} {v}" for k, v in (*route_launches.items(),
                                              *mesh2d_launches.items()))
          + f", direct N=1e5 (10 steps) {direct_launches}, MEDIUM "
          f"dense_backend=xla (10 steps on resident tiles) "
          f"{medium_launches}, DistMesh NCCL D=1 {dist_launches}",
          flush=True)

    def on_paths(name, *paths):
        # A run's counts once, though two names hold them (a DistMesh sweep
        # path's dict is also in SWEEP_LAUNCHES).
        return sum(p.get(name, 0) for p in {id(p): p for p in paths}.values())

    sc_paths = (small_launches, route_launches["SMALL mesh"],
                mesh2d_launches["SMALL 2D -> supercell"],
                dist_launches["SMALL census"])
    print(json.dumps({"kernels": [
        kernel_entry("fused_pairs", on_paths(
            "fused_pairs", res_launches, route_launches["UNEVEN mesh"],
            route_launches["2e7 mesh banded"], mesh2d_launches["2D resident"],
            mesh2d_launches["UNEVEN cyclic"], medium_launches,
            *(dist_launches[k] for k in ("flagship fast", "UNEVEN census",
                                         "UNEVEN cyclic",
                                         "flagship 2D fast"))),
            on_path[("v4", True)]),
        kernel_entry("fused_pairs_v1", v1_launches["fused_pairs_v1"],
              on_path[("v2", True, False)]),
        kernel_entry("dense_pairwise_forces", dense_launches["dense_forces"],
              forces[10_000]),
        kernel_entry("dense_collisions", dense_launches["dense_collisions"],
              colls[(10_000, False)]),
        kernel_entry("fused_pairs_sub", on_paths("fused_pairs_sub", *sc_paths),
              sub_rec),
        kernel_entry("supercell_cell_sums", on_paths("supercell_cell_sums",
                                              *sc_paths), sums_rec),
        *(kernel_entry(k, direct_launches[k], direct_recs[k], DIRECT_SOURCE)
          for k in ("direct_forces", "direct_collisions")),
        *(kernel_entry(k, on_paths(k, res_launches, banded_launches,
                                   medium_launches, *dist_launches.values()),
                       adv_recs[k], ADVANCE_SOURCE)
          for k in ADVANCE_KERNELS),
        *sweep_entries(sweep_recs),
        kernel_entry("migrate_pack", sum(
            v.get("pack", 0) + v.get("compact", 0)
            for v in SWEEP_LAUNCHES.values()), mesh_recs["migrate_pack"],
            MIGRATE_SOURCE),
        kernel_entry("monopole_gathered", on_paths(
            "monopole_gathered", small_launches, mesh_launches,
            *route_launches.values(), *mesh2d_launches.values(),
            medium_launches, *dist_launches.values()),
            mesh_recs["monopole_gathered"], ADVANCE_SOURCE),
        kernel_entry("monopole_supercell", on_paths(
            "monopole_supercell", *sc_paths),
            mesh_recs["monopole_supercell"], ADVANCE_SOURCE),
        *(kernel_entry(k, on_paths(
            k, dense_launches, tiered_launches, small_launches, small_cli,
            mesh_launches, *route_launches.values(),
            *mesh2d_launches.values(), medium_launches,
            *dist_launches.values(), *SWEEP_LAUNCHES.values()),
            stencil_recs[k], STENCIL_SOURCE) for k in STENCIL_KERNELS),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
