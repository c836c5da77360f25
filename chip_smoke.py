#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (one NVIDIA GPU, Hopper).

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printed as one JSON line:

  1. device: a CUDA card is required (exit 1 without one); prints the
     card's name and power limit as nvidia-smi reports them;
  2. build: compiles the hand-written kernels from
     mpi_cuda_process_tpu_torch/ops/cuda/csrc with nvcc (sm_90a), all
     sources in parallel;
  3. kernels: every kernel against its plain PyTorch version on the card,
     on random inputs.  K1 raw_step_heat (7/27/13-point), K2 raw_step_wave,
     K3 fused_step, K4 zchunk_heat and K5 zchunk_wave at an aligned
     (128, 128, 256), a ragged (66, 70, 130) and the main path's 512^3 grid;
     K3's sharded mode and K6 fused_zslab against k plain sharded steps on
     2x2 and 4x1 meshes of virtual shards at (128, 128, 256) and
     (68, 70, 130), guard-frame and periodic; K9 fused_yzslab on 2x2 and
     1x4 meshes at (128, 128, 256) and (68, 76, 130) (ragged shards); the
     overlap shells (K3's sharded mode over a 2m-deep core) against their
     plain version on random strips, and the overlapped padded, z-slab and
     2-axis steps against k plain sharded steps.  K10, the streaming
     kernel: stream_step (RAW) for k = 1, 2, 4 at (128, 128, 256),
     (68, 76, 130) and the main path's 512^3 grid, stream_zslab and
     stream_yzslab on random cores, slabs and corners (one shard of a
     z-only mesh of 4, of a 2x2 and of a 1x4 mesh), all held to their
     plain versions with max |d| = 0 (bit for bit), and the stream kind's
     sharded steps (--mesh 4, 2x2, 1x4, with and without the overlap
     shells) against k plain sharded steps.  2D: K7 whole2d (life,
     heat2d) and K8 fullgrid (life, heat2d, wave2d; the whole grid, RAW,
     and row shards of virtual meshes, PADDED, with and without the
     overlap shells; k = 1, 2, 4, 8; guard-frame and periodic) at an
     aligned (128, 256), ragged (130, 258) and (1000, 777) and the main
     path's 16384^2 grid.  Advection (Courant numbers of both signs) and
     Gray-Scott: K1 raw_step_heat<advect3d> and raw_step_grayscott at
     (128, 128, 256), (66, 70, 130) and 512^3; K3 fused_step for k = 1,
     2, 4, guard-frame and periodic, at the same shapes (512^3: k = 4);
     K3's sharded mode on 2x2 and 4x1 meshes, its overlap shells and the
     overlapped padded step; K8 fullgrid_step and fullgrid_padded for
     advect2d and grayscott2d at (128, 256) and (130, 258), k = 1, 2, 4,
     8, guard-frame and periodic, and at 16384^2 (k = 8).  Red-black SOR
     (the kinds of every k-step kernel, 2k one-colour half-sweeps a pass):
     K3 fused_step for k = 1..4 and at 512^3, K3's sharded mode on 2x2
     and 4x1 meshes, K6, K9 on 2x2 and 1x4, the overlap shells and the
     overlapped padded, z-slab and 2-axis steps, K10 stream_step for k =
     1, 2, 4 and at 512^3, stream_zslab / stream_yzslab on random pieces
     and the stream kind's sharded steps with and without the shells, K8
     fullgrid_step for k = 1, 2, 3, 4, 8 and fullgrid_padded on --mesh 4
     row splits (with the shells where the rows host them), guard-frame
     and periodic, each bit-equal (max |d| = 0).  K10's advection (both
     Courant signs) and Gray-Scott kinds: stream_step, stream_zslab and
     stream_yzslab for k = 1..4 (and stream_step at 512^3), bit for bit,
     and their sharded steps.  --exchange rdma: the stream kind's sharded
     step through the ring kernel against the in-process exchange, bit for
     bit (heat3d, wave3d, advect3d, grayscott3d, sor3d on 4, 2x2 and 1x4
     meshes, with and without the shells).  The ring exchange (row 19):
     ring_exchange against plain_ring_exchange, bit for bit, on every ring
     of z (4), y (1x4) and 2x2 meshes, at the main path's z slab, y slab
     and corner sites and small slabs cut into (0, 4) and (0, 1) chunks,
     ring depths 2, 3, 4 and a preferred chunk count 8, three launches back
     to back with every chunk's ready counter read after each (drained:
     the blocks that wrote the chunk).  bfloat16 kinds,
     each bit-equal to its plain version on bfloat16 tensors: K1's four
     tap sets (advection with both Courant signs), K2 and
     raw_step_grayscott at (66, 70, 130) and 512^3, two steps; K10 RAW at
     (68, 76, 130) and 512^3, ZSLAB on one shard of 1024^3 --mesh 4 and
     YZSLAB on one of 1024^3 --mesh 2,2, every family; the ring exchange
     at the f32 sites, config 5's (4, 4096, 4096) z-slab site and a ragged
     one (2-byte units); K3 (RAW at (66, 70, 130) and 512^3; PADDED on a
     shard's padded block), its overlap shells, K6 and K9 (a shard's
     random core, slabs and corners of a (128, 128, 256) grid and of
     512^3), every family at its bfloat16 k (8; heat3d4th and sor3d 4),
     guard-frame and periodic; K4 (three tap sets) and K5 on a ragged
     padded block and one 1024^3 2x2 shard's, K7 at (130, 258) and
     16384^2, K8 RAW for every float 2D family at k = 3 and 16 (sor2d 8),
     guard-frame and periodic, at (130, 258) and at 16384^2, and K8 PADDED
     through the --mesh 4 stepper (with and without the overlap shells)
     and on one 16384^2 shard's padded block.  K6 and K9 for advection
     (both Courant signs) and Gray-Scott in float32: on random pieces for
     k = 1..4 and through their sharded steps (--mesh 4, 2x2, 1x4, with
     and without the shells), bit for bit.  Tolerances:
     raw steps (K1, K2, Gray-Scott) atol = 0; compute_fn kernels rtol =
     atol = 1e-6; fused k-step
     atol = 1e-4, rtol = 0; Life (int32) exactly equal; guard-frame cells
     exactly equal; atol = 0 compares the bits, so a cell that overflows
     alike in both (bfloat16 Gray-Scott from uniform random fields at
     16384^2, k = 16: 85 cells of -inf) counts as equal.  K10 and K8's
     streaming kind (csrc/ring.cuh, redesigned): every streamfused.TILES
     and fullgrid.RING_TILES entry at its table tile with the fast paths
     and on the per-cell path (PATHS = 0), K10 as RAW, ZSLAB and YZSLAB on
     a (40, 112, 320) core and K8 as RAW and PADDED at (144, 1600), bit for
     bit.  K1, K2, Gray-Scott's raw step, K4, K5 and K7, redesigned
     (csrc/march.cuh): held bit for bit at every shape above
     (raw_step_heat, raw_step_wave, raw_step_grayscott, zchunk_heat,
     zchunk_wave and whole2d at atol 0, frame cells equal), and every
     kernels.TILES and rawstep.TILES kind at its table tile on blocks
     whose x extent falls in each residue mod 8, one plane, one row, one
     cell (the raw kinds: the smallest grid they take, two steps, every
     field), narrow ones, a run that does not divide the march extent,
     raw grids whose every tile touches a wall beside grids with interior
     tiles and, in bfloat16, inputs with subnormals, signed zeros and sums
     on bfloat16 ties;
  4. main path, unsharded: ``cli.main()`` at 512^3 float32 — heat3d and
     wave3d for 100 iterations, heat3d27 and heat3d4th for 40, each with
     --compute jnp, --compute pallas, --fuse K (K = 4; 2 for heat3d4th)
     and --fuse K --fuse-kind stream (K10), each kernel path held against
     its jnp run; a checkpoint round trip
     (--checkpoint-every 50, --resume to 100) bit for bit.  2D: BASELINE
     config 1, heat2d and mdf at 512^2 for 1000 iterations and Life at
     512^2, --init random --density 0.15 (the reference's universe), each
     with --compute jnp, --compute pallas (K7; heat2d and life) and
     --fuse 8 (K8); at 16384^2 life and heat2d with
     jnp / pallas / fuse 8, and wave2d --fuse 8 against jnp (96
     iterations: the multiple of k = 8 nearest 100).  Advection (--param
     cz=-0.25: both upwind directions) and Gray-Scott (its patch init) at
     512^3 for 40 iterations with --compute jnp, --compute pallas (K1's
     advection kind, raw_step_grayscott), --fuse 4 (K3) and --fuse 4
     --fuse-kind stream (K10), each held against its jnp run; sor3d at 512^3 for 40 iterations with --compute
     jnp, --fuse 4 (K3) and --fuse 4 --fuse-kind stream (K10), held
     against jnp; sor2d at 512^2 as a solver, --fuse 8 --tol 1e-3
     --tol-check-every 8 against its --compute jnp twin (the same
     converged step, the same fields);
  5. main path, sharded (MPI_CUDA_PROCESS_TORCH_VIRTUAL_DEVICES=4: four
     shards on the one card — decomposition overhead, not scaling):
     ``cli.run()`` at 1024^3 float32, --init pulse, 100 iterations, heat3d
     and wave3d, each --mesh 2,2 with --compute jnp, --compute pallas (K4 /
     K5), --fuse 4 (K3 sharded) and --mesh 4 --fuse 4 --fuse-kind padfree
     (K6) and --mesh 2,2 --fuse 4 --fuse-kind padfree (K9), heat3d also
     --compute pallas --overlap, --mesh 2,2 --fuse 4 --overlap and --mesh 4
     --fuse 4 --fuse-kind padfree --overlap, heat3d and wave3d also --mesh
     2,2 --fuse 4 --fuse-kind padfree --overlap (the overlap shells), and
     the stream kind (K10): unsharded --fuse 4 --fuse-kind stream, --mesh
     2,2 --fuse 4 --fuse-kind stream with and without --overlap and
     --mesh 4 --fuse 4 --fuse-kind stream, each also with --exchange rdma
     (the ring kernel; bit-equal to its in-process twin); heat3d27 and
     heat3d4th at 512^3
     --mesh 2,2 for 20 iterations with --compute pallas, --fuse (4 / 2),
     --fuse --fuse-kind padfree and --fuse --fuse-kind stream.  Every
     sharded field is held against the unsharded run of the same mode and
     the unsharded plain run; overlap must equal non-overlap bit for bit.
     Then a sharded checkpoint round trip at 512^3 --mesh 2,2
     through ``cli.main()`` (--checkpoint-every 50, --resume to 100), bit
     for bit.  2D: life and heat2d at 16384^2, 96 iterations, --mesh 4
     (a row split) with --compute jnp, pallas (K7), pallas --overlap,
     --fuse 8 (K8 sharded) and --fuse 8 --overlap, and life --mesh 2
     --compute pallas --overlap (the reference's two-rank program), each
     against the unsharded run of the same mode and the unsharded plain
     run, overlap bit-equal to non-overlap; a Life --mesh 4 --fuse 8
     checkpoint round trip at 4096^2, bit for bit.  Advection and
     Gray-Scott: at 512^3, 100 iterations, --mesh 2,2 with --compute jnp,
     --fuse 4 (K3 sharded, both Gray-Scott fields exchanged), --fuse 4
     --overlap (the shells) and --fuse 4 --fuse-kind stream with and
     without --exchange rdma (against the unsharded stream and jnp runs,
     bit-equal to each other) and --mesh 4 --fuse 4 --fuse-kind stream
     (K10's z-slab kind of the two families); at 16384^2, 96 iterations, advect2d
     (--param cx=-0.4) and grayscott2d with --compute jnp and --fuse 8
     (K8), and grayscott2d --mesh 4 --fuse 8 with and without --overlap,
     each against the unsharded runs as above; and their pad-free kinds at
     512^3, --mesh 2,2 (K9) and --mesh 4 (K6) --fuse 4 --fuse-kind
     padfree, each with and without --overlap.  Red-black SOR: sor3d at
     1024^3, 20 iterations, --mesh 2,2 with --compute jnp, --fuse 4 (K3
     sharded) with and without --overlap, --fuse-kind padfree (K9) and
     stream (K10), and --mesh 4 padfree (K6) and stream; sor2d at 16384^2,
     96 iterations, jnp, --fuse 8 and --mesh 4 --fuse 8 with and without
     --overlap, each against its unsharded same-mode and plain runs;
  5b. the bfloat16 main path (``cli.run()``): every K10 family at 512^3
     for 8 iterations with --compute pallas (the raw kinds), the stream
     kind unsharded, on --mesh 4 and on --mesh 2,2 --exchange rdma, and
     --fuse 8 (K3; heat3d4th and sor3d --fuse 4), advect3d and
     grayscott3d also --fuse 8 --fuse-kind padfree on --mesh 2,2 (K9) and
     --mesh 4 (K6), each with and without --overlap; heat3d and wave3d at
     1024^3 for 100 iterations with --compute pallas, the stream kind and
     --mesh 2,2 stream with and without --exchange rdma, and for 96
     iterations with --fuse 8 unsharded, on --mesh 2,2 (padded, pad-free
     and stream, each with and without --overlap) and --mesh 4 pad-free
     (K6), beside their f32 twins' ms/step; BASELINE config 3's
     decomposition, --mesh 2,2 --compute pallas (K4 / K5), for heat3d,
     heat3d27, heat3d4th and wave3d at 512^3 and heat3d and wave3d at
     1024^3 with and without --overlap; --periodic --compute pallas at
     512^3 for ITERS beside its f32 run; at 16384^2 for 96 iterations
     heat2d and mdf --compute pallas (K7), heat2d also on --mesh 4 with and
     without --overlap, and every float 2D family at --fuse 16 (sor2d 8;
     K8) unsharded and on --mesh 4 with and without --overlap; every kernel
     run bit-equal to the plain bf16 run of the same grid, every --overlap
     run to its non-overlap twin, its bf16 launch counters exact; the
     unsharded stream kind of every family and K8 of every float 2D
     family also on the per-cell path (PATHS = 0), bit-equal alike;
  5c. BASELINE config 5: the rehearsal line of tests/test_cli.py:422-424
     (wave3d 192x64x128 --mesh 8,1,1 --fuse 4 --fuse-kind stream --dtype
     bfloat16 --mem-check error) on 8 virtual shards against the plain bf16
     run at atol 1e-3, and with --overlap, which must log the fallback to
     the non-split step (its K3 shells would have m = 4, off bfloat16's
     alignment unit) and equal the line without it bit for bit; then one
     card's share of the full-width run, four
     of its 64 (64, 4096, 4096) shards (--grid 256,4096,4096 --mesh 4,1,1,
     40 iterations, --mem-check error), with and without --exchange rdma,
     each bit-equal to the unsharded stream run, printed with its ms/step,
     Mcells/s, the budget's estimate and the measured peak; its float32
     twin where the budget admits it, else the refusal; and BASELINE
     config 3's decomposition in bfloat16 (heat3d 1024^3 --mesh 2,2
     --compute pallas, 16 iterations), whose measured peak must not exceed
     the estimate, as config 5's --exchange rdma share's must not;
  5d. decomposition across processes: BASELINE config 3 as users run it,
     heat3d 1024^3 --mesh 2,2 as 4 processes on the card for 20
     iterations, with --compute pallas (K4), --fuse 4 --fuse-kind padfree
     (K9), --fuse 4 --fuse-kind stream (K10) and --fuse 4 --overlap (K3
     sharded and its shells), and --compute pallas in bfloat16; wave3d
     1024^3 --mesh 4 as 4 processes, --compute pallas (K5) and --fuse 4
     --fuse-kind padfree (K6); Life 16384^2 --mesh 2 as 2 processes, 24
     iterations, --compute pallas (K7) and --fuse 8 (K8 sharded).  Each
     process is this script again (--mp-worker), started with the
     launcher's variables; the processes share the card, so their slabs
     cross through gloo and pinned host buffers.  Each process
     fingerprints its final blocks on the card (int sums of the raw bits,
     plain and weighted by position) and every block must equal the same
     --mesh run's in one process, its --log-every lines must equal that
     run's and the launches of all processes must add up to its; each
     run's ms/step is printed beside the one-process run's, with the
     backend and the exchange's host time per step call.  With two cards
     or more the NCCL leg (a card per process) runs heat3d's K4 and K9
     runs too; with one card it prints that it did not run, and why;
  5e. the pipelined slab-carry exchange and the sharded checkpoint: heat3d
     1024^3 --mesh 2,2 --fuse 4 with --fuse-kind padfree (K9), padfree
     --overlap (K9 and the K3 shells), stream and stream --exchange rdma
     (K10 and the ring), and wave3d bfloat16 --mesh 4 --fuse 8 --fuse-kind
     padfree (K6), each in one process (virtual devices) without, with,
     with and without --pipeline, in turns: block fingerprints bit-equal,
     launches equal, every ms/step printed; heat3d 1024^3 --mesh 2,2
     --fuse 4 --fuse-kind padfree --overlap without, with, with and
     without --pipeline as 4 processes (gloo through pinned host buffers,
     as in 5d), each bit-equal to its one-process run and the one-process
     runs to each other, with ms/step and the exchange's host time a
     pass; then the sharded
     checkpoint (--checkpoint-backend orbax: torch.distributed.checkpoint,
     each process its own blocks) of heat3d 512^3 on --mesh 2,2 as 4
     processes, --checkpoint-every 8 to 24 iterations, killed by
     FAULT_INJECT=exchange:step=16:sigkill on every rank (each must die
     by SIGKILL, leaving step 8 the newest), resumed as 2 processes on
     --mesh 4 and as one unsharded process, each bit-equal to the
     uninterrupted run; every process's write and read seconds and bytes
     from its log lines;
  5f. the ring across processes (ROADMAP B7): --exchange rdma on the
     stream kind as processes that share the card, the slabs carried by
     ring_send / ring_drain (stores into the peers' CUDA IPC-mapped
     receive slots under ready flags and credits): heat3d 1024^3 --mesh
     2,2 --fuse 4 --fuse-kind stream as 4 processes, with --overlap and in
     bfloat16, as 2 processes of 2 shards, and config 5's share (wave3d
     256x4096x4096 bf16 --mesh 4,1,1, 8 iterations) as 4 processes, each
     beside its gloo-host twin in the same launch: every run bit-equal to
     its one-process run (and the one-process rdma runs to their stream
     twins), one ring_send and one ring_drain a process for every
     ring_exchange launch of the one-process run, every site's flags and
     credits drained, ms/step beside the twin's and the one-process run's
     with each transport's host time a step call, and the processes'
     summed peaks (plus the ring's regions), over the set-up and over the
     time loop, each at or under --mem-check's estimate;
     each launch opens with a short warm-up run of the ring; with two
     cards or more the NCCL leg (a card a process, the
     peer writes over NVLink), else NOT RUN and why.  Phase 3 holds
     ring_send / ring_drain to the plain peer ring (the same protocol
     walked by the host over a region tensor) and to the shift itself, bit
     for bit, at these sites (four shards a launch and one), over five
     epochs on two slots, and a drain past a 0.25 s deadline records its
     place and raises; phase 6 times both at the 4-process launch shape;
  5g. the default --compute auto (the dispatch tables, filled from
     scripts/torch_dispatch_times.py's H100 timings): BASELINE config 1
     (heat2d 512^2, 1000 iterations), config 2 (heat3d 256^3) and config
     3 (heat3d 1024^3 --mesh 2,2), and one 512^3 run per 3D family, each
     with no --compute flag: its launch counters must name the kernel the
     tables promise (K8, K1, K4, K2, Gray-Scott's raw step, K3) and equal
     the explicit-flag run's, its fields equal that run's bit for bit, and
     its ms/step is printed beside the explicit and the plain run's (a
     second auto run, warm, is the one timed); then --debug-checks and
     --check-finite on a heat2d 512^2 blow-up (alpha 1e9) must raise
     naming the step the plain step, driven by hand, first makes
     non-finite, and config 2's auto run with --dump-every 25 must write
     the state at each dump step through the native writer (whose g++
     build must succeed).  Earlier phases that mean the plain path pass
     --compute jnp;
  5h. the ensemble axis: every batched kernel against its plain version
     and its members' own launches, then --ensemble runs beside the
     unbatched runs of their first and last members;
  5i. device groups (--groups, --group-transport): BASELINE config 3
     split into two coupled 1x2 groups of the stream kind (K10 YZSLAB) on
     4 virtual devices, in float32 and with bf16 clauses, each bit-equal
     to the monolithic --mesh 2,2 --fuse 4 --fuse-kind stream run, and
     README's heterogeneous demo at base 512^3 (K3's padded kind in both
     groups) on 8, held to the same runner through the plain versions of
     its kernels within 1e-4; each under both transports (bit-equal to
     each other), its peak at or under the coupled --mem-check estimate,
     then ms a coupled round, the exchange's share, launches a round and
     the monolithic twin's ms for the same steps, by CUDA events.  The
     kernels line gives each kernel's groups_launches;
  5j. the observability layer (--telemetry, --health, --halo-audit,
     --anomaly, --profile): BASELINE config 3 (heat3d 1024^3 --mesh 2,2,
     4 virtual devices) with --fuse 4 --fuse-kind stream (K10) beside
     its obs-off twin: fields bit-equal, the step's launch counters
     equal, the log valid, every health record HEALTHY, every audit
     clean, no anomaly, the recorder's peak at or under --mem-check's
     estimate; the same with --exchange rdma --halo-audit 1 (the
     audit's ring_exchange launches under their own keys); a child with
     FAULT_INJECT=numerics:step=20:nan that must exit DIVERGED at step
     20 with no checkpoint past 16 and a valid flight-recorder bundle;
     --profile on K9 --overlap (the attribution available: device-busy,
     interior and exchange time, overlap efficiency, idle share); 4
     processes (gloo-host) whose health records equal the one-process
     run's; phase 5i's config 3 split with per-group records; the
     heartbeat's probe and its CUDA context's bytes; ms/step with obs
     on and off, ms a health check and an audit pass, by CUDA events.
     The kernels line gives each kernel's obs_launches;
  5k. the live console and the campaign ledger (--serve, obs/ledger.py):
     config 3 (K10 on 4 virtual devices, 400 iterations) with --serve 0
     beside its telemetry-only twin: fields bit-equal, the step's launch
     counters equal, one serve event, scrapes from a thread while it runs
     with the step and obs_events_total rising, no obs-serve thread left,
     and the same with --exchange rdma (the ring); ms/step
     telemetry-only and served (the console polling the live log,
     a scraper every 0.25 s) by CUDA events in 3 alternations, and each
     /metrics scrape's time; its log ingested by `python -m
     mpi_cuda_process_tpu_torch.obs.ledger ingest` (one ok row, backend
     cuda, the card and its power limit in its provenance; `best` prints
     it), a served --anomaly rerun seeded from that row (no roofline_gap;
     the console serves obs_ledger_best_known{...,backend="cuda"}), the
     flight recorder's best_known the same row; 4 processes (gloo-host) at
     512^3 with --serve 0: process 0's /status.json with 4 hosts rows, the
     others binding nothing.  The kernels line gives each kernel's
     serve_launches;
  5l. the cost model, the launch checks and --supervise (obs/costmodel.py,
     utils/launchcheck.py, resilience/supervisor.py): config 3 as K10, K9
     --overlap and K10 --exchange rdma, config 2 (heat3d 256^3) and
     config 1 (heat2d 512^2) under --compute auto, each through cli.run
     with --telemetry: one costmodel event whose counts equal the run's
     own (the in-process transport's bytes a pass and shard, the
     ring_exchange launches a pass) and one recorded pass of the built
     step (shifts, bytes, ring launches), the rdma cross-check matching,
     the console's roofline gap ratio at least 1 wherever the fields pass
     the 50 MB L2 (printed for all, with the predicted and measured
     ms/step); the launch checks on recorded passes of K9 --overlap and
     K10 --overlap --pipeline (the interior on the main stream between the
     side stream's post and its wait), K10 --exchange rdma, an --ensemble
     4 step and a --groups round under --group-transport collective;
     --supervise on config 3's K10 command at 512^3 with a checkpoint
     every 8 steps, three supervised runs at once: a hang at step 24
     killed on its STALLED verdict and a SIGKILL at step 24 seen dead,
     each resumed from step 16 with its final fields equal to an
     unsupervised twin (each attempt's seconds, resume step and kill to
     resume printed), and a permanent hang giving up with --max-restarts
     1, exit 1, its bundle's tunnel field the card probe's OK.  The
     kernels line gives each kernel's costmodel_launches;
  6. timing: each kernel, its plain version and, where one PyTorch call
     computes the same function, that call (F.conv3d / F.conv2d with TF32
     off; advection's upwind weights as one F.conv3d), by CUDA events at
     the main path's shapes, beside the bound from bytes and flops (K10 at
     the shapes of K3, K6 and K9; the SOR kinds at the shapes of its main
     path; advection and Gray-Scott at 512^3 and on one 2x2 shard); the
     ring exchange at the heat3d 1024^3 sites (2x2 z slab, y slab and
     corner, --mesh 4 z slab) beside one copy_ per slab, its launches per
     100 iterations, and once issued on a side stream beside K10's
     interior (does it run beside it or wait); every --exchange rdma CLI
     run's ms/step beside its ppermute twin, and the stream kind's sharded
     step with each exchange in turns (heat3d 1024^3, Gray-Scott 512^3,
     2x2, with and without the shells); and the split of
     one sharded step at 1024^3 on 2x2 into exchange/pad, kernel and
     re-pin, beside whole fused steps of each kind with and without
     --overlap.  The bfloat16 kinds at the same shapes (bytes at 2 B a cell;
     F.conv3d in bfloat16 beside K1 and K2, one copy_ per slab beside the
     ring, at the 1024^3 2x2 sites and config 5's z-slab site; each ring
     site, f32 and bf16, also by device time alone from torch.profiler,
     beside its copy_ calls), K10's advect3d and grayscott3d z-slab kind
     on a --mesh 4 shard of 512^3; K3 in bfloat16 at 512^3 for every
     family, its sharded mode, one hi z shell and K9 on a 2x2 shard and K6 on a --mesh 4 shard of 1024^3
     (heat3d, wave3d, k = 8), and K6 and K9 of advect3d and grayscott3d
     on the shards of 512^3 (float32 k = 4, bfloat16 k = 8); K4 / K5 in
     bfloat16 on the 2x2 shards (F.conv3d in bfloat16 beside them), K7 at
     16384^2 (F.conv2d in bfloat16) and K8 at 16384^2 and on a --mesh 4
     shard, every float 2D family at k = 16 (sor2d 8).  Then one line for
     each timed entry of the kernels this port redesigned for Hopper (K3,
     its shells, K6, K9: rows 5-11; the ring: row 19; K8 and K10: rows
     15-18; K4, K5 and K7: rows 12-14; K1: rows 1 and 3; K2 and
     raw_step_grayscott: rows 2 and 4): this run's ms beside the first
     design's (OLD_MS, from PERF.md), the fraction of the bound and the
     library call's ms (null for K8, K10 and Gray-Scott: no one PyTorch
     call computes a k-step pass or a reaction step).  The
     split of one step into pad (exchange/pad), kernel and re-pin also
     for bfloat16 heat3d at 1024^3 on 2x2 and for heat2d --compute pallas
     at 16384^2 in float32 and bfloat16.

Every launch counter is set to 0 just before each main-path run and read
just after.  The line before the last lists the kernels as JSON; the last
line is ``{"ok": true, "device": {...}}``.  Any failure raises: exit code 1,
no result line.  Scratch (checkpoints) goes to build/chip_smoke/ and is
removed.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "mpi_cuda_process_tpu_torch"
MAIN = (512, 512, 512)
BIG = (1024, 1024, 1024)
ITERS = 100
# (stencil, iterations, fuse k) of the unsharded main path at MAIN: heat3d
# and wave3d at full depth, the other two tap sets cut to 40 iterations.
MAIN_RUNS = (("heat3d", ITERS, 4), ("wave3d", ITERS, 4),
             ("heat3d27", 40, 4), ("heat3d4th", 40, 2))
# (stencil, grid, iterations, fuse k, overlapped modes) of the sharded main
# path; every run has --mesh 2,2 with jnp, pallas, --fuse k, --fuse k
# --fuse-kind padfree and --fuse k --fuse-kind stream, and at BIG also
# --mesh 4 --fuse k with --fuse-kind padfree and stream.  An overlapped
# mode runs right after its non-overlap base.
# The stream kind's --exchange rdma modes (rdma_*) run with the overlapped
# and ring modes a stencil lists, right after their twin.
MESH_RUNS = (("heat3d", BIG, ITERS, 4, ("overlap", "fuse_overlap",
                                        "padfree_overlap", "yzslab_overlap",
                                        "stream_yz_overlap", "rdma_yz",
                                        "rdma_yz_overlap", "rdma_z")),
             ("wave3d", BIG, ITERS, 4, ("yzslab_overlap",
                                        "stream_yz_overlap", "rdma_yz",
                                        "rdma_yz_overlap", "rdma_z")),
             ("heat3d27", MAIN, 20, 4, ()), ("heat3d4th", MAIN, 20, 2, ()))
# overlapped mode -> the non-overlap mode it must equal bit for bit, and
# rdma mode -> the same run with in-process exchange copies (ppermute)
OVERLAP_BASE = {"overlap": "pallas", "fuse_overlap": "fuse",
                "padfree_overlap": "padfree", "yzslab_overlap": "yzslab",
                "stream_yz_overlap": "stream_yz"}
RDMA_BASE = {"rdma_yz": "stream_yz", "rdma_yz_overlap": "stream_yz_overlap",
             "rdma_z": "stream_z"}
TWIN = {**OVERLAP_BASE, **RDMA_BASE}
# Advection and Gray-Scott: (stencil, iterations, fuse k) of the unsharded
# main path at MAIN (--compute jnp, pallas, --fuse k, --fuse k --fuse-kind
# stream) and (stencil, grid, iterations, fuse k, overlapped and ring
# modes) of the sharded one (--mesh 2,2 jnp, --fuse k, the stream kind with
# and without --exchange rdma, the pad-free kinds on --mesh 2,2 (K9) and
# --mesh 4 (K6), each with and without --overlap).
NEW_MAIN_RUNS = (("advect3d", 40, 4), ("grayscott3d", 40, 4))
NEW_PADFREE = ("padfree_overlap", "yzslab_overlap")
NEW_MESH_RUNS = (("advect3d", MAIN, ITERS, 4, ("fuse_overlap", "rdma_yz")
                  + NEW_PADFREE),
                 ("grayscott3d", MAIN, ITERS, 4, ("fuse_overlap", "rdma_yz")
                  + NEW_PADFREE))
NEW_FAMILIES = ("advect3d", "grayscott3d", "advect2d", "grayscott2d")
# Red-black SOR: (stencil, iterations, fuse k) of the unsharded main path at
# MAIN (--compute jnp, --fuse k and its stream kind: SOR has no raw-step or
# compute_fn kernel) and (stencil, grid, iterations, fuse k, overlapped
# modes) of the sharded one (--mesh 2,2 jnp, --fuse k padded, padfree and
# stream; --mesh 4 padfree and stream).  Its 2D runs: sor2d at GRID2D
# (jnp, --fuse 8, --mesh 4 --fuse 8 with and without --overlap) and a --tol
# run at BASE2D against its jnp twin.
SOR_MAIN_RUNS = (("sor3d", 40, 4),)
SOR_MESH_RUNS = (("sor3d", BIG, 20, 4, ("fuse_overlap",)),)
SOR = ("sor3d", "sor2d")
# families without a compute_fn kernel (their --mesh runs take no pallas
# mode)
NO_COMPUTE_FN = NEW_FAMILIES + SOR
# SOR --tol run at BASE2D: the tolerance, the check cadence (a multiple of
# FUSE2D) and the iteration cap
SOR_TOL = ("1e-3", 8, 40000)
# Parameters every run of a stencil takes (its CLI runs as --param flags):
# advection with a negative Courant number on one axis, so both upwind
# directions run on the main path.
STENCIL_PARAMS = {"advect3d": {"cz": -0.25}, "advect2d": {"cx": -0.4}}
# bfloat16: the kernels that take it (K1's four tap sets, K2,
# raw_step_grayscott, K10 in every mode, the ring exchange) and the k of
# each K10 family on the bf16 main path (every family at 512^3 for
# BF16_ITERS iterations: --compute pallas, the stream kind unsharded, on
# --mesh 4 and on --mesh 2,2 --exchange rdma, each bit-equal to the plain
# bf16 run); heat3d and wave3d also at 1024^3 for ITERS beside their f32
# twins of phase 5.
BF16 = "bfloat16"
BF16_FAMILIES = (("heat3d", 4), ("heat3d27", 4), ("heat3d4th", 2),
                 ("wave3d", 4), ("advect3d", 4), ("grayscott3d", 4),
                 ("sor3d", 2))
BF16_ITERS = 8
# The bfloat16 k of each family on K3, K6 and K9 (the window alignment, 2m
# a multiple of 16): --fuse 8 for the halo-1 families, 4 for heat3d4th and
# sor3d, every family at 512^3 for BF16_ITERS; heat3d and wave3d also at
# 1024^3 for ITERS16K (a multiple of 8) unsharded, on --mesh 2,2 padded and
# pad-free with and without --overlap, the stream kind with --overlap, and
# --mesh 4 pad-free, beside their f32 --fuse 4 twins of phase 5;
# advect3d and grayscott3d also pad-free on --mesh 2,2 and --mesh 4 at
# 512^3, with and without --overlap.
BF16_FUSE = {"heat3d": 8, "heat3d27": 8, "heat3d4th": 4, "wave3d": 8,
             "advect3d": 8, "grayscott3d": 8, "sor3d": 4}
# The bfloat16 k of each float 2D family on K8 (JAX's bfloat16 alignment, m
# a multiple of 16: k = 16, sor2d's margin 2k: k = 8); every family at
# 16384^2 for ITERS16K (a multiple of 16) unsharded and on --mesh 4 with
# and without --overlap, beside their f32 --fuse 8 twins of phase 5.
BF16_FUSE2D = {"heat2d": 16, "wave2d": 16, "advect2d": 16,
               "grayscott2d": 16, "sor2d": 8}
# BASELINE config 5 (wave3d 4096^3 bf16 on 64 chips, z-sharded, --fuse 4
# --fuse-kind stream): the rehearsal line of tests/test_cli.py:422-424 on 8
# virtual shards, and one card's share of the full-width run, 4 of its 64
# (64, 4096, 4096) shards on virtual devices, with and without --exchange
# rdma, held to the unsharded stream run; its f32 twin runs where
# --mem-check admits it.
CONFIG5_REHEARSAL = ("--grid", "192,64,128", "--iters", "8", "--mesh",
                     "8,1,1", "--fuse", "4", "--fuse-kind", "stream",
                     "--dtype", "bfloat16", "--mem-check", "error")
CONFIG5_GRID = (256, 4096, 4096)
CONFIG5_ITERS = 40


# K10 and K8's streaming kind at every table entry and on both paths
# (phase 3): a grid with interior columns (x and y inside the grid past
# the widest tile's margin) beside wall ones, and a 2D grid of ragged
# strips and chunks with interior strips, rows enough for the streaming
# kind at every k of the table (fullgrid.RING_MIN_LEADS lead-ins).
RING3D = (40, 112, 320)
RING2D = (144, 1600)

# The kernels this port redesigned for Hopper (rows 5-11: K3, its shells,
# K6 and K9; row 19: the ring; rows 15-18: K8 and K10; rows 12-14: K4, K5
# and K7; rows 1 and 3: K1; rows 2 and 4: K2 and raw_step_grayscott), and
# each timed entry's ms per launch in its first design, on one NVIDIA H100
# 80GB HBM3 at 700.00 W (PERF.md section 6), printed beside this run's.
REDESIGNED = ("fused_step", "fused_step_padded", "fused_shell",
              "fused_zslab", "fused_yzslab", "ring_exchange", "stream_step",
              "stream_zslab", "stream_yzslab", "fullgrid_step",
              "fullgrid_padded", "zchunk_heat", "whole2d", "zchunk_wave",
              "raw_step_heat", "raw_step_wave", "raw_step_grayscott")
OLD_MS = {
    "raw_step_heat<heat3d>": 0.4506, "raw_step_heat<heat3d27>": 0.6988,
    "raw_step_heat<heat3d4th>": 0.5503, "raw_step_heat<advect3d>": 0.5453,
    "raw_step_heat<heat3d,bfloat16>": 0.4210,
    "raw_step_heat<heat3d27,bfloat16>": 1.8874,
    "raw_step_heat<heat3d4th,bfloat16>": 0.9674,
    "raw_step_heat<advect3d,bfloat16>": 0.5560,
    "raw_step_wave": 0.5830, "raw_step_wave<wave3d,bfloat16>": 0.5119,
    "raw_step_grayscott": 0.8494,
    "raw_step_grayscott<grayscott3d,bfloat16>": 1.0003,
    "zchunk_heat<heat3d>": 0.8784, "zchunk_heat<heat3d27>": 0.2119,
    "zchunk_heat<heat3d4th>": 0.1642,
    "zchunk_heat<heat3d,bfloat16>": 0.7687,
    "zchunk_heat<heat3d27,bfloat16>": 0.4940,
    "zchunk_heat<heat3d4th,bfloat16>": 0.2704,
    "whole2d<heat2d>": 1.1859, "whole2d<life>": 1.2768,
    "whole2d<heat2d,bfloat16>": 1.1916,
    "zchunk_wave": 1.1981, "zchunk_wave<wave3d,bfloat16>": 0.9518,
    "stream_step<heat3d>": 4.2067, "stream_step<heat3d27>": 7.7793,
    "stream_step<heat3d4th>": 2.6682, "stream_step<wave3d>": 5.1798,
    "stream_step<sor3d>": 18.6173, "stream_step<advect3d>": 5.8207,
    "stream_step<grayscott3d>": 8.9425,
    "stream_step<heat3d,bfloat16>": 6.6669,
    "stream_step<heat3d27,bfloat16>": 17.6041,
    "stream_step<heat3d4th,bfloat16>": 5.5888,
    "stream_step<wave3d,bfloat16>": 7.7743,
    "stream_step<advect3d,bfloat16>": 8.7849,
    "stream_step<grayscott3d,bfloat16>": 11.2296,
    "stream_step<sor3d,bfloat16>": 7.1360,
    "stream_zslab<heat3d>": 7.4326, "stream_zslab<wave3d>": 11.0882,
    "stream_zslab<sor3d>": 38.2713, "stream_zslab<advect3d>": 1.5468,
    "stream_zslab<grayscott3d>": 2.5161,
    "stream_zslab<heat3d,bfloat16>": 10.1293,
    "stream_zslab<heat3d27,bfloat16>": 30.0020,
    "stream_zslab<heat3d4th,bfloat16>": 7.8493,
    "stream_zslab<wave3d,bfloat16>": 12.2814,
    "stream_zslab<advect3d,bfloat16>": 11.3682,
    "stream_zslab<grayscott3d,bfloat16>": 20.1967,
    "stream_zslab<sor3d,bfloat16>": 10.4559,
    "stream_yzslab<heat3d>": 8.6316, "stream_yzslab<wave3d>": 11.7004,
    "stream_yzslab<heat3d27>": 3.2603, "stream_yzslab<heat3d4th>": 1.2060,
    "stream_yzslab<sor3d>": 38.0607, "stream_yzslab<advect3d>": 2.7216,
    "stream_yzslab<grayscott3d>": 2.5692,
    "stream_yzslab<heat3d,bfloat16>": 10.2568,
    "stream_yzslab<heat3d27,bfloat16>": 32.6063,
    "stream_yzslab<heat3d4th,bfloat16>": 8.5628,
    "stream_yzslab<wave3d,bfloat16>": 12.6302,
    "stream_yzslab<advect3d,bfloat16>": 12.0209,
    "stream_yzslab<grayscott3d,bfloat16>": 21.9197,
    "stream_yzslab<sor3d,bfloat16>": 10.7745,
    "fullgrid_step<life>": 6.0504, "fullgrid_step<heat2d>": 5.3629,
    "fullgrid_step<wave2d>": 5.6534, "fullgrid_step<advect2d>": 6.4016,
    "fullgrid_step<grayscott2d>": 11.1175, "fullgrid_step<sor2d>": 14.3324,
    "fullgrid_padded<life>": 1.4886, "fullgrid_padded<heat2d>": 1.3211,
    "fullgrid_padded<grayscott2d>": 2.7151, "fullgrid_padded<sor2d>": 3.5648,
    "fullgrid_step<heat2d,bfloat16>": 19.9003,
    "fullgrid_step<wave2d,bfloat16>": 23.6713,
    "fullgrid_step<advect2d,bfloat16>": 20.1362,
    "fullgrid_step<grayscott2d,bfloat16>": 56.1746,
    "fullgrid_step<sor2d,bfloat16>": 20.5328,
    "fullgrid_padded<heat2d,bfloat16>": 4.9023,
    "fullgrid_padded<wave2d,bfloat16>": 5.9148,
    "fullgrid_padded<advect2d,bfloat16>": 5.0463,
    "fullgrid_padded<grayscott2d,bfloat16>": 14.0877,
    "fullgrid_padded<sor2d,bfloat16>": 5.1492,
    "fused_step<heat3d>": 8.5527, "fused_step<heat3d27>": 11.0989,
    "fused_step<heat3d4th>": 6.3436, "fused_step<wave3d>": 9.3300,
    "fused_step<advect3d>": 10.0955, "fused_step<grayscott3d>": 18.7024,
    "fused_step<sor3d>": 28.8485,
    "fused_step_padded<heat3d>": 17.6024,
    "fused_step_padded<wave3d>": 18.4364,
    "fused_step_padded<heat3d27>": 2.8171,
    "fused_step_padded<heat3d4th>": 1.6156,
    "fused_step_padded<advect3d>": 2.5295,
    "fused_step_padded<grayscott3d>": 4.4706,
    "fused_step_padded<sor3d>": 59.5067,
    "fused_shell<heat3d>": 0.3079, "fused_shell<wave3d>": 0.3239,
    "fused_shell<sor3d>": 1.9379, "fused_shell<advect3d>": 0.0846,
    "fused_shell<grayscott3d>": 0.1357,
    "fused_zslab<heat3d>": 19.0354, "fused_zslab<wave3d>": 24.1003,
    "fused_zslab<sor3d>": 59.9848, "fused_zslab<advect3d>": 2.6226,
    "fused_zslab<grayscott3d>": 6.4000,
    "fused_yzslab<heat3d>": 20.0993, "fused_yzslab<wave3d>": 27.5781,
    "fused_yzslab<heat3d27>": 3.1120, "fused_yzslab<heat3d4th>": 1.8779,
    "fused_yzslab<sor3d>": 62.0180, "fused_yzslab<advect3d>": 2.8012,
    "fused_yzslab<grayscott3d>": 6.5478,
    "fused_step<heat3d,bfloat16>": 38.4600,
    "fused_step<heat3d27,bfloat16>": 88.6786,
    "fused_step<heat3d4th,bfloat16>": 28.5243,
    "fused_step<wave3d,bfloat16>": 40.4781,
    "fused_step<advect3d,bfloat16>": 44.5342,
    "fused_step<grayscott3d,bfloat16>": 86.8240,
    "fused_step<sor3d,bfloat16>": 21.3584,
    "fused_step_padded<heat3d,bfloat16>": 78.4460,
    "fused_step_padded<wave3d,bfloat16>": 81.5291,
    "fused_shell<heat3d,bfloat16>": 2.5511,
    "fused_shell<wave3d,bfloat16>": 2.6599,
    "fused_zslab<heat3d,bfloat16>": 79.1871,
    "fused_zslab<wave3d,bfloat16>": 96.8868,
    "fused_zslab<advect3d,bfloat16>": 11.3552,
    "fused_zslab<grayscott3d,bfloat16>": 25.8588,
    "fused_yzslab<heat3d,bfloat16>": 83.4406,
    "fused_yzslab<wave3d,bfloat16>": 100.5316,
    "fused_yzslab<advect3d,bfloat16>": 11.9593,
    "fused_yzslab<grayscott3d,bfloat16>": 26.5037,
    "ring_exchange<4x512x1024>": 0.2032, "ring_exchange<512x4x1024>": 0.1870,
    "ring_exchange<4x4x1024>": 0.1068, "ring_exchange<4x1024x1024>": 0.3695,
    "ring_exchange<4x512x1024,bfloat16>": 0.1069,
    "ring_exchange<512x4x1024,bfloat16>": 0.1054,
    "ring_exchange<4x4x1024,bfloat16>": 0.1029,
    "ring_exchange<4x4096x4096,bfloat16>": 2.7851}


def stencil_flags(stencil):
    return tuple(f for key, v in STENCIL_PARAMS.get(stencil, {}).items()
                 for f in ("--param", f"{key}={v}"))


def raw_key(stencil, dtype=None):
    """The launch counter key of a 3D stencil's whole-step raw kernel
    (``dtype``: the bfloat16 kind's, "raw_step_heat[heat3d,bfloat16]")."""
    return {"wave3d": "raw_step_wave", "grayscott3d": "raw_step_grayscott"
            }.get(stencil, "raw_step_heat") + (
                f"[{stencil},{dtype}]" if dtype else f"[{stencil}]")


def zchunk_key(stencil, dtype=None):
    """The launch counter key of a 3D stencil's compute_fn kernel (K4, K5;
    ``dtype``: the bfloat16 kind's)."""
    return ("zchunk_wave" if stencil == "wave3d" else "zchunk_heat") + (
        f"[{stencil},{dtype}]" if dtype else f"[{stencil}]")
EPS32 = 2.0 ** -23
FLOPS_PER_CELL = {"heat3d": 10, "heat3d27": 55, "heat3d4th": 27,
                  "wave3d": 12, "heat2d": 7, "wave2d": 9,
                  "life": 10,  # life: integer adds and compares
                  # the kernels' fadd/fsub/fmul per cell (stencil_taps.cuh,
                  # stencil2d.cuh): 3 per upwind axis; Gray-Scott two
                  # Laplacians, (u v) v and the two reaction updates
                  "advect3d": 9, "grayscott3d": 27, "advect2d": 6,
                  "grayscott2d": 23,
                  # SOR: each cell is relaxed once a step (in the half-sweep
                  # of its colour) with heat's taps
                  "sor3d": 10, "sor2d": 7}
# 2D: BASELINE config 1 (heat2d 512^2, 1000 iterations) and the size that
# fills the card with real work (16384^2: 1.07 GB per field).
BASE2D = (512, 512)
ITERS2D = 1000
GRID2D = (16384, 16384)
ITERS16K = 96  # the multiple of FUSE2D nearest 100
FUSE2D = 8
LIFE_CKPT_GRID = (4096, 4096)  # the 2D sharded checkpoint round trip
TPU = "mpi_cuda_process_tpu/ops/pallas/"
# Decomposition across processes (phase 5d): (label, processes, stencil,
# grid, iterations, --log-every, flags), each run as that many processes on
# the card (gloo through pinned host buffers: the processes share it) and
# held bit for bit, with its --log-every lines, to the same --mesh run in
# one process.  BASELINE config 3 as users run it (4 processes of heat3d
# 1024^3 on 2x2) on the compute_fn kernel K4, the pad-free kind K9, the
# streaming kind K10 and the padded kind K3 with its overlap shells, and in
# bfloat16; wave3d on --mesh 4 (K5, K6); Life on the reference's 2-rank
# row split (K7, K8).
MP_ITERS = 20
MP_RUNS = (
    ("heat3d_pallas", 4, "heat3d", BIG, MP_ITERS, 4,
     ("--mesh", "2,2", "--compute", "pallas")),
    ("heat3d_padfree", 4, "heat3d", BIG, MP_ITERS, 4,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree")),
    ("heat3d_stream", 4, "heat3d", BIG, MP_ITERS, 4,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream")),
    ("heat3d_fuse_overlap", 4, "heat3d", BIG, MP_ITERS, 4,
     ("--mesh", "2,2", "--fuse", "4", "--overlap")),
    ("heat3d_pallas_bf16", 4, "heat3d", BIG, MP_ITERS, 4,
     ("--mesh", "2,2", "--compute", "pallas", "--dtype", "bfloat16")),
    ("wave3d_pallas", 4, "wave3d", BIG, MP_ITERS, 4,
     ("--mesh", "4", "--compute", "pallas")),
    ("wave3d_padfree", 4, "wave3d", BIG, MP_ITERS, 4,
     ("--mesh", "4", "--fuse", "4", "--fuse-kind", "padfree")),
    ("life_pallas", 2, "life", (16384, 16384), 24, 8,
     ("--mesh", "2", "--compute", "pallas")),
    ("life_fuse", 2, "life", (16384, 16384), 24, 8,
     ("--mesh", "2", "--fuse", "8")),
)
# the runs of the NCCL leg (a card per process; 2 or 4 of them)
MP_NCCL = ("heat3d_pallas", "heat3d_padfree")
MP_TIMEOUT = 420  # seconds, each launch of processes
# The pipelined slab-carry exchange (phase 5e): (label, stencil, grid,
# iterations, flags), each run in one process (virtual devices) without,
# with, with and without --pipeline (in turns, so that neither pays the
# first run's set-up alone), bit-equal, the same launches.
PIPE_RUNS = (
    ("heat3d_padfree", "heat3d", BIG, 20,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree")),
    ("heat3d_padfree_overlap", "heat3d", BIG, 20,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree",
      "--overlap")),
    ("heat3d_stream", "heat3d", BIG, 20,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream")),
    ("heat3d_stream_rdma", "heat3d", BIG, 20,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream",
      "--exchange", "rdma")),
    ("wave3d_bf16_padfree", "wave3d", BIG, 24,
     ("--mesh", "4", "--fuse", "8", "--fuse-kind", "padfree", "--dtype",
      "bfloat16")),
)
# ... and across processes: 4 processes of the overlapped pad-free kind
# without, with, with and without --pipeline (in turns, in each process),
# as phase 5d runs them, but logging only at the end: the run is one
# chunk, so the carry spans all its passes (a chunk reseeds it).
_PIPE_MP = ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "padfree",
            "--overlap")
PIPE_MP_RUNS = tuple(
    (label, 4, "heat3d", BIG, MP_ITERS, MP_ITERS, flags)
    for label, flags in (
        ("heat3d_padfree_overlap", _PIPE_MP),
        ("heat3d_padfree_overlap_pipeline", _PIPE_MP + ("--pipeline",)),
        ("heat3d_padfree_overlap_pipeline_again",
         _PIPE_MP + ("--pipeline",)),
        ("heat3d_padfree_overlap_again", _PIPE_MP)))
# The sharded checkpoint across processes (phase 5e): heat3d at MAIN on the
# plain path, checkpointed every CK_EVERY steps for CK_ITERS, the 4-process
# run killed at the CK_KILL boundary on every rank.
CK_ITERS, CK_EVERY, CK_KILL = 24, 8, 16
# The ring across processes (phase 5f, ROADMAP B7): --exchange rdma on the
# stream kind as processes that share the card, each beside its gloo-host
# twin in the same launch (the run without the flag) and held to its run
# in one process: BASELINE config 3 (heat3d 1024^3 2x2) as 4 processes,
# with --overlap and in bfloat16, as 2 processes of 2 shards, and config
# 5's share (wave3d 256x4096x4096 bf16 on --mesh 4,1,1) as 4 processes at
# a reduced iteration count.  (label, processes, stencil, grid,
# iterations, --log-every, flags)
_STREAM22 = ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream")
_RDMA = ("--exchange", "rdma")
_C5 = ("--mesh", "4,1,1", "--fuse", "4", "--fuse-kind", "stream",
       "--dtype", "bfloat16")
# Each launch opens with a short warm-up run of the ring (held like the
# rest), so no timed run pays the processes' first-run set-up, and the
# pairs alternate which of the two goes first.
PEER_ITERS, PEER_C5_ITERS = 40, 8
PEER_RUNS = (
    ("warmup", 4, "heat3d", (128, 128, 256), 8, 4, _STREAM22 + _RDMA),
    ("heat3d_stream", 4, "heat3d", BIG, PEER_ITERS, 8, _STREAM22),
    ("heat3d_rdma", 4, "heat3d", BIG, PEER_ITERS, 8, _STREAM22 + _RDMA),
    ("heat3d_rdma_overlap", 4, "heat3d", BIG, PEER_ITERS, 8,
     _STREAM22 + _RDMA + ("--overlap",)),
    ("heat3d_stream_overlap", 4, "heat3d", BIG, PEER_ITERS, 8,
     _STREAM22 + ("--overlap",)),
    ("heat3d_stream_bf16", 4, "heat3d", BIG, PEER_ITERS, 8,
     _STREAM22 + ("--dtype", "bfloat16")),
    ("heat3d_rdma_bf16", 4, "heat3d", BIG, PEER_ITERS, 8,
     _STREAM22 + _RDMA + ("--dtype", "bfloat16")),
    ("wave3d_c5_rdma", 4, "wave3d", CONFIG5_GRID, PEER_C5_ITERS, 4,
     _C5 + _RDMA),
    ("wave3d_c5_stream", 4, "wave3d", CONFIG5_GRID, PEER_C5_ITERS, 4, _C5),
    ("warmup_on_2", 2, "heat3d", (128, 128, 256), 8, 4, _STREAM22 + _RDMA),
    ("heat3d_stream_on_2", 2, "heat3d", BIG, PEER_ITERS, 8, _STREAM22),
    ("heat3d_rdma_on_2", 2, "heat3d", BIG, PEER_ITERS, 8,
     _STREAM22 + _RDMA))
# the NCCL leg (a card per process, the peer writes over NVLink)
PEER_NCCL = ("heat3d_stream", "heat3d_rdma")
# The default --compute auto (phase 5g): BASELINE config 1 (heat2d 512^2,
# 1000 iterations), config 2 (heat3d 256^3) and config 3 (heat3d 1024^3 on
# --mesh 2,2), and one 512^3 run per 3D family, each as users run it (no
# --compute flag) beside the explicit-flag run of the path the dispatch
# tables promise and the plain run.  (label, stencil, grid, iterations,
# flags)
AUTO_RUNS = (
    ("config1", "heat2d", BASE2D, ITERS2D, ()),
    ("config2", "heat3d", (256, 256, 256), ITERS, ()),
    ("config3", "heat3d", BIG, 20, ("--mesh", "2,2")),
) + tuple((f"{name}_512", name, MAIN, 40, ()) for name in (
    "heat3d", "heat3d27", "heat3d4th", "wave3d", "advect3d", "grayscott3d",
    "sor3d"))
# the sanitizers on the card: heat2d at 512^2 with an unstable alpha (the
# hot walls' neighbours grow ~4e9-fold a step until float32 overflows),
# --check-finite every SAN_EVERY steps; the dumps of config 2's auto run
# every DUMP_EVERY steps
SAN_ALPHA, SAN_ITERS, SAN_EVERY = 1e9, 12, 3
DUMP_EVERY = 25

# The ensemble axis (phase 5h, ROADMAP A7): each batched kernel held to its
# plain version and to its unbatched launches on ENS_CHECK_N members (3, so
# a member stride that is off shows), then the CLI runs users would make
# with --ensemble: README's Life 128^2 x 64 and heat3d 256^3 on an
# ensemble mesh, BASELINE config 1's heat2d 512^2 x 64 on K8, config 2's
# heat3d 256^3 x 8 on K3 and K10, heat3d 512^3 x 2 on a 2x2 mesh of the
# stream kind with the ring, wave3d 256^3 x 4 on K5.  (label, stencil,
# grid, iterations, members, flags, virtual devices, the batched kernels
# its run launches).  Each run's batch and its member N-1 are then timed
# apart by CUDA events: ENS_TIMED chunks of the run's iterations after a
# warm-up chunk, the median.
ENS_CHECK_N = 3
ENS_TIMED = 3
ENS_RUNS = (
    ("life_128_x64", "life", (128, 128), 100, 64, (), 0,
     ("whole2d[life,ensemble]",)),
    ("heat2d_512_x64_fuse8", "heat2d", BASE2D, 200, 64, ("--fuse", "8"), 0,
     ("fullgrid_step[heat2d,ensemble]",)),
    ("heat3d_256_x8_fuse4", "heat3d", (256, 256, 256), 40, 8,
     ("--fuse", "4"), 0, ("fused_step[heat3d,ensemble]",)),
    ("heat3d_256_x8_stream", "heat3d", (256, 256, 256), 40, 8,
     ("--fuse", "4", "--fuse-kind", "stream"), 0,
     ("stream_step[heat3d,ensemble]",)),
    ("heat3d_256_x8_emesh2_221", "heat3d", (256, 256, 256), 100, 8,
     ("--ensemble-mesh", "2", "--mesh", "2,2,1", "--ensemble-perturb",
      "0.01"), 8, ("zchunk_heat[heat3d,ensemble]",)),
    ("heat3d_512_x2_22_stream_rdma", "heat3d", MAIN, 20, 2,
     ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream",
      "--exchange", "rdma"), 4, ("stream_yzslab[heat3d,ensemble]",)),
    ("wave3d_256_x4_22_pallas", "wave3d", (256, 256, 256), 20, 4,
     ("--mesh", "2,2", "--compute", "pallas"), 4,
     ("zchunk_wave[wave3d,ensemble]",)),
)

# Device groups (phase 5i, ROADMAP A7): --groups through cli.run as users
# run it.  BASELINE config 3 (heat3d 1024^3, 2x2) split into two coupled
# 1x2 groups of the stream kind (K10 YZSLAB) on 4 virtual devices; the
# split leaves the middle 4 rows off centre (z127/256: group grids of 512
# and 520 rows; the even split's 516 rows are refused by every fused
# builder of the JAX package), held bit for bit to the monolithic --mesh
# 2,2 --fuse 4 --fuse-kind stream run, in float32 and with bf16 clauses;
# README's heterogeneous demo at base 512^3 (a 2x-refined wave3d hot
# region inside a heat3d far field, K3's padded kind in both groups) on 8,
# held to the same runner through the plain versions of its kernels.
# Each under both transports, bit-equal to each other; GROUP_ROUNDS rounds
# a held run, then ms a round by CUDA events (a warm-up chunk of
# GROUP_CHUNK rounds, then GROUP_TIMED chunks), the exchange alone, the
# launches a round and the monolithic twin's ms for the same steps.
# (label, stencil, base grid, --groups, virtual devices, the monolithic
# twin's flags or None, the kernels each round launches)
GROUP_ROUNDS = 5
GROUP_CHUNK = 5
GROUP_TIMED = 3
GROUP_SPLIT = ("heat3d@0-1:z127/256:fuse4+stream:mesh1x2,"
               "heat3d@2-3:fuse4+stream:mesh1x2")
GROUP_TWIN = ("--mesh", "2,2", "--fuse", "4", "--fuse-kind", "stream")
GROUP_RUNS = (
    ("config3_split_stream", "heat3d", BIG, GROUP_SPLIT, 4, GROUP_TWIN,
     ("stream_yzslab[heat3d]",)),
    ("config3_split_stream_bf16", "heat3d", BIG,
     GROUP_SPLIT.replace("heat3d@", "heat3d:bf16@"), 4,
     GROUP_TWIN + ("--dtype", "bfloat16"),
     ("stream_yzslab[heat3d,bfloat16]",)),
    ("readme_hetero_512", "wave3d", MAIN,
     "wave3d:fine@0-3:z1/4:mesh1x4:fuse4,heat3d:coarse@4-7:mesh1x4:fuse4",
     8, None, ("fused_step_padded[wave3d]", "fused_step_padded[heat3d]")),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def fingerprint(block):
    """An exact fingerprint of a tensor's bits, computed on its device: the
    sum of its raw bit patterns as integers, and the same sum weighted by
    each cell's position along every axis (so moved cells change it too),
    reduced a chunk of the first axis at a time in int64 and added up in
    Python integers, which never overflow."""
    import torch

    itype = {4: torch.int32, 2: torch.int16}[block.element_size()]
    plane = max(1, block[0].numel())
    step = max(1, (1 << 24) // plane)
    plain, weighted = 0, 0
    col = [0] * block.shape[-1]
    row = [0] * (block.shape[1] if block.dim() == 3 else 0)
    for z0 in range(0, block.shape[0], step):
        b = block[z0:z0 + step].contiguous().view(itype).to(torch.int64)
        per_z = b.reshape(b.shape[0], -1).sum(1).tolist()
        plain += sum(per_z)
        weighted += sum((z0 + i + 1) * v for i, v in enumerate(per_z))
        for i, v in enumerate(b.reshape(-1, b.shape[-1]).sum(0).tolist()):
            col[i] += v
        if row:
            for i, v in enumerate(b.sum((0, 2)).tolist()):
                row[i] += v
    weighted += sum((i + 1) * v for i, v in enumerate(col))
    weighted += sum((i + 1) * v for i, v in enumerate(row))
    return [plain, weighted]


def mp_argv(stencil, grid, iters, log_every, flags):
    """The CLI arguments of a phase-5d run (Life from its random universe,
    the rest from the pulse)."""
    return ["--stencil", stencil, "--grid", ",".join(map(str, grid)),
            "--iters", str(iters), "--init",
            "random" if stencil == "life" else "pulse",
            *stencil_flags(stencil), *flags, "--log-every", str(log_every)]


def mp_worker(spec_path: str) -> int:
    """One process of a phase-5d launch: runs every case of the spec
    through ``cli.run()`` with the launcher's variables set, and writes
    per case its blocks' fingerprints, its log lines, its launches, its
    ms/step and its transport's figures."""
    sys.path.insert(0, HERE)
    import torch

    from mpi_cuda_process_tpu_torch import cli, driver
    from mpi_cuda_process_tpu_torch.ops.cuda import (fullgrid, fused,
                                                     kernels, rawstep,
                                                     remote, streamfused)
    from mpi_cuda_process_tpu_torch.parallel import halo
    from mpi_cuda_process_tpu_torch.parallel import mesh as mesh_lib

    # the time loop's peak apart from the set-up's (the initial fields):
    # the peak is read and reset as the loop starts
    set_up_peak = [None]
    run_simulation = driver.run_simulation

    def timed_loop(*args, **kwargs):
        torch.cuda.synchronize()
        set_up_peak[0] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return run_simulation(*args, **kwargs)

    driver.run_simulation = timed_loop

    with open(spec_path) as fh:
        spec = json.load(fh)
    rank = int(os.environ["RANK"])
    lines = []

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log = logging.getLogger(PKG)
    log.setLevel(logging.INFO)
    log.addHandler(Grab())
    counters = (rawstep.launches, fused.launches, kernels.launches,
                fullgrid.launches, streamfused.launches, remote.launches)
    out = []
    for case in spec["cases"]:
        lines.clear()
        for c in counters:
            c.clear()
        for t in halo._DISTRIBUTED.values():
            t.reset_stats()
        halo._PEER_TRANSPORTS.clear()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        set_up_peak[0] = None
        fields, mcells = cli.run(cli.config_from_args(case["argv"]))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        set_up = peak if set_up_peak[0] is None else set_up_peak[0] - held
        launches = {}
        for c in counters:
            launches.update(c)
        mesh = fields[0].mesh
        transport = halo.default_transport(mesh)
        peer = None
        if halo._PEER_TRANSPORTS:
            ring = halo._PEER_TRANSPORTS[-1]
            sites = ring.peer_sites()
            peer = {"backend": ring.backend, "stats": dict(ring.stats),
                    "sites": [[s_.name, s_.sent, s_.drained, s_.region_bytes,
                               s_.unit, s_.blocks] for s_ in sites],
                    "region_bytes": sum(s_.region_bytes for s_ in sites)}
        fps = {f"{j}:{','.join(map(str, c))}": fingerprint(b)
               for j, f in enumerate(fields)
               for c, b in zip(mesh.local_coords(), f)}
        cells = math.prod(case["grid"])
        out.append({"label": case["label"], "fingerprints": fps,
                    "lines": list(lines), "launches": launches,
                    "ms_per_step": 1e3 * cells / (mcells * 1e6),
                    "backend": transport.backend,
                    "transport": dict(transport.stats),
                    "blocks": len(fields[0]), "device": str(mesh.devices[0]),
                    "peak_bytes": peak, "set_up_peak_bytes": set_up,
                    "peer": peer})
        del fields
        torch.cuda.empty_cache()
    with open(f"{spec['out']}_r{rank}.json", "w") as fh:
        json.dump(out, fh)
    mesh_lib.shutdown_distributed()
    return 0


def multiprocess_phase(counted, lines, main_launches, scratch, runs=MP_RUNS,
                       nccl_runs=MP_NCCL, tag="multiprocess"):
    """Phase 5d (and 5e's runs across processes): every run of ``runs`` in
    one process (virtual devices), then as its processes on the card, held
    bit for bit (block fingerprints, --log-every lines, launches) to the
    one-process run; with two cards or more, the NCCL leg of
    ``nccl_runs``.  Returns (one line of figures per run, what the NCCL
    leg did, each run's one-process figures)."""
    import torch

    from mpi_cuda_process_tpu_torch import cli
    from mpi_cuda_process_tpu_torch.parallel import mesh as mesh_lib

    saved_virtual = os.environ.get(mesh_lib.VIRTUAL_DEVICES_ENV)
    mp = {}
    mp_dir = os.path.join(scratch, tag)
    os.makedirs(mp_dir, exist_ok=True)

    def step_lines(got):
        return [ln for ln in got if ln.startswith("step ")]

    def step_calls(iters, log_every, flags):
        """Calls of the step function in a run: one a pass, and for a
        one-step run also the residual step of each --log-every line."""
        if "--fuse" in flags:
            return iters // int(flags[flags.index("--fuse") + 1])
        return iters + iters // log_every

    # the same runs in one process, on virtual devices, first
    for label, procs, stencil, grid, iters, le, flags in runs:
        os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = str(
            math.prod(int(v) for v in flags[1].split(",")))
        argv = mp_argv(stencil, grid, iters, le, flags)
        lines.clear()
        (fields, mcells), got = counted(
            lambda: cli.run(cli.config_from_args(argv)))
        mesh = fields[0].mesh
        mp[label] = {
            "argv": argv, "grid": list(grid), "processes": procs,
            "one_process_ms_per_step": 1e3 * math.prod(grid)
            / (mcells * 1e6),
            "one_process_launches": got, "lines": step_lines(lines),
            "fingerprints": {f"{j}:{','.join(map(str, c))}": fingerprint(b)
                             for j, f in enumerate(fields)
                             for c, b in zip(mesh.local_coords(), f)},
            "calls": step_calls(iters, le, flags)}
        if not mp[label]["lines"]:
            fail(f"{tag} {label}: no --log-every line logged")
        del fields, mesh
        torch.cuda.empty_cache()
    os.environ.pop(mesh_lib.VIRTUAL_DEVICES_ENV, None)

    def launch(world, labels, tag):
        """Run ``labels`` as ``world`` processes of this script (the
        launcher's variables, a free port); returns each process's results
        per label."""
        import socket

        spec = os.path.join(mp_dir, f"{tag}.json")
        with open(spec, "w") as fh:
            json.dump({"out": os.path.join(mp_dir, tag), "cases": [
                {"label": lb, "argv": mp[lb]["argv"], "grid": mp[lb]["grid"]}
                for lb in labels]}, fh)
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
        env.pop(mesh_lib.VIRTUAL_DEVICES_ENV, None)
        torch.cuda.empty_cache()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mp-worker", spec],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=MP_TIMEOUT)
                errs.append(err)
                if p.returncode != 0:
                    fail(f"multiprocess {tag}: a process exited "
                         f"{p.returncode}:\n{err[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        res = []
        for r in range(world):
            with open(os.path.join(mp_dir, f"{tag}_r{r}.json")) as fh:
                res.append({c["label"]: c for c in json.load(fh)})
        return res

    def held(label, per_rank, want_backend):
        """Check one label's processes against its one-process run;
        returns its line of figures."""
        ref = mp[label]
        fps, launches = {}, {}
        for got in per_rank:
            c = got[label]
            if c["backend"] != want_backend:
                fail(f"multiprocess {label}: backend {c['backend']} != "
                     f"{want_backend}")
            if not any(f"transport {want_backend}" in ln
                       for ln in c["lines"]):
                fail(f"multiprocess {label}: the mesh line names no "
                     f"{want_backend} transport")
            if step_lines(c["lines"]) != ref["lines"]:
                fail(f"multiprocess {label}: --log-every lines differ from "
                     f"one process's: {step_lines(c['lines'])} against "
                     f"{ref['lines']}")
            if c["blocks"] * len(per_rank) != len(ref["fingerprints"]) // \
                    len(set(k.split(":")[0] for k in ref["fingerprints"])):
                fail(f"multiprocess {label}: {c['blocks']} blocks a process")
            fps.update(c["fingerprints"])
            for k, n in c["launches"].items():
                launches[k] = launches.get(k, 0) + n
                main_launches[k] = main_launches.get(k, 0) + n
        if fps != ref["fingerprints"]:
            bad = sorted(k for k in ref["fingerprints"]
                         if fps.get(k) != ref["fingerprints"][k])
            fail(f"multiprocess {label}: blocks differ from one process's "
                 f"run: {bad}")
        peers = [got[label]["peer"] for got in per_rank]
        want = dict(ref["one_process_launches"])
        if any(peers):
            # the peer ring: each process sends and drains once for each
            # ring_exchange launch of the one-process run, on every site
            if not all(p and p["backend"] == "cuda-peer-ring"
                       for p in peers):
                fail(f"multiprocess {label}: the peer ring did not carry "
                     f"every process's exchange: {peers}")
            for c in per_rank:
                if "exchange: mode=rdma backend=cuda-peer-ring" not in \
                        c[label]["lines"] or not any(
                            ln.startswith("exchange: peer ring drained")
                            for ln in c[label]["lines"]):
                    fail(f"multiprocess {label}: no peer-ring backend or "
                         "drained line logged")
            for p in peers:
                for name, sent, drained, *_ in p["sites"]:
                    if sent != drained or sent < 1:
                        fail(f"multiprocess {label}: site {name} sent "
                             f"{sent}, drained {drained}")
            for key in [k for k in want if k.startswith("ring_exchange[")]:
                n = want.pop(key)
                for wrapper in ("ring_send", "ring_drain"):
                    want[wrapper + key[len("ring_exchange"):]] = \
                        n * len(per_rank)
        if launches != want:
            fail(f"multiprocess {label}: launches {launches} != the "
                 f"expected {want} (the one-process run's: "
                 f"{ref['one_process_launches']})")
        stats = [got[label]["transport"] for got in per_rank]
        calls = ref["calls"]
        extra = {}
        if any(peers):
            extra = {
                "peer_ring_host_ms_per_step_call": max(
                    1e3 * p["stats"]["seconds"] / calls for p in peers),
                "peer_ring_bytes_sent_per_step_call": max(
                    p["stats"]["bytes"] / calls for p in peers),
                "peer_ring_sites": peers[0]["sites"],
                "peer_ring_region_bytes": sum(p["region_bytes"]
                                              for p in peers)}
        return {**extra, "label": label, "processes": len(per_rank),
                "peak_bytes_all_processes": sum(
                    got[label]["peak_bytes"] for got in per_rank),
                "set_up_peak_bytes_all_processes": sum(
                    got[label]["set_up_peak_bytes"] for got in per_rank),
                "argv": " ".join(ref["argv"]), "backend": want_backend,
                "ms_per_step": per_rank[0][label]["ms_per_step"],
                "one_process_ms_per_step": ref["one_process_ms_per_step"],
                "exchange_ms_per_step_call": max(
                    1e3 * s["seconds"] / calls for s in stats),
                "exchange_bytes_sent_per_step_call": max(
                    s["bytes"] / calls for s in stats),
                "shifts_per_step_call": stats[0]["shifts"] / calls,
                "step_calls": calls, "launches": launches,
                "bit_equal_to_one_process": True,
                "log_lines_equal": len(ref["lines"])}

    mp_out = []
    for world in (4, 2):
        labels = [r[0] for r in runs if r[1] == world]
        if not labels:
            continue
        per_rank = launch(world, labels, f"gloo_host_{world}")
        for label in labels:
            row = held(label, per_rank, "gloo-host")
            mp_out.append(row)
            emit({"phase": "multiprocess_run", **row})
    cards = torch.cuda.device_count()
    if not nccl_runs:
        nccl_note = {"ran": False, "reason": "no NCCL leg in this phase"}
    elif cards >= 2:
        world = 4 if cards >= 4 else 2
        per_rank = launch(world, list(nccl_runs), f"nccl_{world}")
        nccl = [held(lb, per_rank, "nccl") for lb in nccl_runs]
        for row in nccl:
            emit({"phase": "multiprocess_run", **row})
        nccl_note = {"ran": True, "processes": world, "runs": len(nccl)}
    else:
        nccl_note = {"ran": False, "reason": (
            f"{cards} card: the nccl leg needs a card for each process, "
            "so it was not run (and is not reported as passed)")}
    if nccl_runs:
        print(f"{tag} nccl leg: " + (
            "ran" if nccl_note["ran"] else "NOT RUN: " + nccl_note["reason"]),
              flush=True)
    shutil.rmtree(mp_dir, ignore_errors=True)
    if saved_virtual is not None:
        os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = saved_virtual
    return mp_out, nccl_note, mp


def _cli_processes(world, argv, env_extra=None):
    """``world`` processes of the port's CLI on the card (the launcher's
    variables and a free port when more than one; no virtual devices
    unless ``env_extra`` sets them); returns (return codes, stderr
    texts), each process bounded by MP_TIMEOUT."""
    import socket

    from mpi_cuda_process_tpu_torch.parallel import mesh as mesh_lib

    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop(mesh_lib.VIRTUAL_DEVICES_ENV, None)
    env.update(env_extra or {})
    if world > 1:
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    procs = [subprocess.Popen(
        [sys.executable, "-m", PKG, *argv],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)) if world > 1 else env,
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    rcs, errs = [], []
    try:
        for p in procs:
            _, err = p.communicate(timeout=MP_TIMEOUT)
            rcs.append(p.returncode)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return rcs, errs


def _io_figures(text):
    """The sharded checkpoint's log lines of one process: [(step or
    'read', bytes, seconds)]."""
    out = []
    for m in re.finditer(r"checkpoint step (\d+): (\d+) bytes of this "
                         r"process's blocks written in ([0-9.]+)s", text):
        out.append((int(m.group(1)), int(m.group(2)), float(m.group(3))))
    for m in re.finditer(r"checkpoint read: (\d+) bytes of this process's "
                         r"blocks in ([0-9.]+)s", text):
        out.append(("read", int(m.group(1)), float(m.group(2))))
    return out


def peer_ring_checks(dev, rand, compare, checked, virtual_mesh, ring_of):
    """Phase 3's checks of ring_send and ring_drain (the ring across
    processes, row 19's peer form) in one process: a site whose every
    neighbour is local (a world of one: the kernels store into this
    process's own receive slots and flags), on every ring of a 2x2 or
    --mesh 4 mesh (4 shards a launch) and on a one-shard ring (one shard
    a launch, the 4-process main path's), at the main path's z slab, y
    slab, corner and config 5's z site and a ragged slab (2- and 4-byte
    units), five epochs a site on two slots (each slot reused): every
    drain bit-equal to the plain version (the same protocol walked by
    the host over a region tensor on the card) and to the shift itself
    (plain_peer_shift); then every flag and credit at the last epoch on
    both.  And the deadline: a drain of an epoch never sent, with a
    0.25 s bound, returns, records its place and raises at the next
    check; the record is cleared and the site runs on."""
    import torch

    from mpi_cuda_process_tpu_torch.ops.cuda import _build, remote
    from mpi_cuda_process_tpu_torch.parallel import mesh as mesh_lib

    peer_sites = [((2, 2), 0, (4, 512, 1024), torch.float32),
                  ((2, 2), 1, (512, 4, 1024), torch.float32),
                  ((2, 2), 1, (4, 4, 1024), torch.float32),
                  ((4,), 0, (4, 4096, 4096), torch.bfloat16),
                  ((2, 2), 1, (4, 512, 1024), torch.bfloat16),
                  ((4,), 0, (3, 5, 130), torch.float32),
                  ((4,), 0, (3, 5, 130), torch.bfloat16)]
    peer_sites += [(None, 0, shape, dtype)
                   for _, _, shape, dtype in peer_sites[:4]]
    for mshape, axis, shape, dtype in peer_sites:
        name = "x".join(map(str, shape)) + (
            f",{BF16}" if dtype == torch.bfloat16 else "")
        _, meta = remote.build_ring_exchange_call(shape, dtype, device=dev)
        if mshape is None:  # one shard, its own next and previous
            group = mesh_lib.make_mesh((1,), [dev])
            to = frm = [((0, 0), (0, 0))]
        else:
            group = virtual_mesh(mshape)
            nxt, prv = ring_of(group, axis)
            to = [((0, nxt[i]), (0, prv[i])) for i in range(4)]
            frm = [((0, prv[i]), (0, nxt[i])) for i in range(4)]
        site = remote.PeerSite(meta, group, to, frm, dev)
        plain = remote.PeerSite(
            meta, group, to, frm, dev, regions=[torch.zeros(
                remote.peer_layout(meta, len(to), 1)["bytes"],
                dtype=torch.uint8, device=dev)])
        for epoch in range(1, 6):
            hi = [rand(shape).to(dtype) for _ in to]
            lo = [rand(shape).to(dtype) for _ in to]
            remote.launches.clear()
            got = site.drain(site.post(hi, lo))
            torch.cuda.synchronize()
            if dict(remote.launches) != {
                    _build.launch_key(w, "x".join(map(str, shape)), hi[0]): 1
                    for w in ("ring_send", "ring_drain")}:
                fail(f"peer ring {name}: launches {dict(remote.launches)}")
            ref = plain.drain(plain.post(hi, lo))
            err = compare(f"ring_send<{name}>", got[0] + got[1],
                          ref[0] + ref[1], 0.0, None)
            compare(f"ring_drain<{name}>", got[0] + got[1],
                    ref[0] + ref[1], 0.0, None)
            direct = remote.plain_peer_shift(hi, lo, frm)
            compare(f"ring_drain<{name}>", got[0] + got[1],
                    direct[0] + direct[1], 0.0, None)
        site.check_drained()
        plain.check_drained()
        checked.append({"kernel": f"ring_send+ring_drain<{name}>",
                        "shape": list(shape), "mesh": mshape, "axis": axis,
                        "shards_a_launch": len(to), "epochs": 5,
                        "nslots": site.nslots, "unit_bytes": site.unit,
                        "blocks_a_chunk": site.blocks,
                        "chunks": [meta["chunk_axis"], meta["nchunks"]],
                        "drained": True, "max_abs_err": err, "atol": 0.0})
        del hi, lo, got, ref, direct
    remote.launches.clear()
    _, meta = remote.build_ring_exchange_call((4, 64, 128), torch.float32,
                                              device=dev)
    site = remote.PeerSite(meta, mesh_lib.make_mesh((1,), [dev]),
                           [((0, 0), (0, 0))], [((0, 0), (0, 0))], dev,
                           timeout_s=0.25)
    held_out = torch.empty((1, 2, 4, 64, 128), device=dev)
    t0 = time.perf_counter()
    site._launch(1, 1, None, held_out)  # epoch 1 was never sent
    torch.cuda.synchronize()
    waited = time.perf_counter() - t0
    try:
        site.check()
        fail("peer ring: a drain past its deadline recorded nothing")
    except remote.PeerTimeout as e:
        timeout_msg = str(e)
    if not 0.25 <= waited < 5 or "epoch 1" not in timeout_msg:
        fail(f"peer ring deadline: {waited:.3f} s, {timeout_msg}")
    remote.reset_peer_record(dev)
    hi = [rand((4, 64, 128))]
    got = site.drain(site.post(hi, hi))
    torch.cuda.synchronize()
    if not torch.equal(got[0][0], hi[0]):
        fail("peer ring: the site after a cleared timeout")
    checked.append({"kernel": "ring_drain deadline", "bound_s": 0.25,
                    "waited_s": waited, "record": timeout_msg})
    remote.free_peer_regions()
    remote.launches.clear()
    del held_out, hi, got


def peer_ring_timing(dev, rand, time_ms, record, kernels_out, p5f):
    """Phase 6's times of ring_send and ring_drain (row 19's peer form)
    at the 4-process main path's launch (one shard a process, both
    directions) for heat3d 1024^3 2x2's z slab, y slab and corner sites
    and config 5's z site, on a one-shard ring in this process, each
    launch of 50 sends and drains in turn timed by its own pair of CUDA
    events.  Plain: the plain peer ring's post or drain (the host walks
    the protocol over a region tensor on the card, polling flags).
    Library: one copy_ per slab.  Bound: each slab read once and
    written once (into its slot, or out of it).  Launches: phase 5f's
    processes (``p5f``), per process and step."""
    import torch

    from mpi_cuda_process_tpu_torch.ops.cuda import _build, remote
    from mpi_cuda_process_tpu_torch.parallel import mesh as mesh_lib

    per_step_peer = {}
    for line in p5f["runs"]:
        if line["label"] in ("heat3d_rdma", "wave3d_c5_rdma") and \
                line["processes"] == 4 and line["backend"] == "gloo-host":
            iters = PEER_C5_ITERS if "c5" in line["label"] else PEER_ITERS
            for key, n in line["ring_launches"].items():
                per_step_peer[key] = n / 4 / iters
    one = mesh_lib.make_mesh((1,), [dev])
    for shape, dtype in (((4, 512, 1024), torch.float32),
                         ((512, 4, 1024), torch.float32),
                         ((4, 4, 1024), torch.float32),
                         ((4, 4096, 4096), torch.bfloat16)):
        sname = "x".join(map(str, shape))
        b16 = dtype == torch.bfloat16
        _, meta = remote.build_ring_exchange_call(shape, dtype, device=dev)
        site = remote.PeerSite(meta, one, [((0, 0), (0, 0))],
                               [((0, 0), (0, 0))], dev)
        plain = remote.PeerSite(
            meta, one, [((0, 0), (0, 0))], [((0, 0), (0, 0))], dev,
            regions=[torch.zeros(remote.peer_layout(meta, 1, 1)["bytes"],
                                 dtype=torch.uint8, device=dev)])
        hi, lo = [rand(shape).to(dtype)], [rand(shape).to(dtype)]
        for _ in range(3):
            site.drain(site.post(hi, lo))
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        send_ms = drain_ms = 0.0
        for _ in range(50):
            ev[0].record()
            epoch = site.post(hi, lo)
            ev[1].record()
            site.drain(epoch)
            ev[2].record()
            torch.cuda.synchronize()
            send_ms += ev[0].elapsed_time(ev[1]) / 50
            drain_ms += ev[1].elapsed_time(ev[2]) / 50
        site.check_drained()
        plain_send = plain_drain = 0.0
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epoch = plain.post(hi, lo)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            plain.drain(epoch)
            torch.cuda.synchronize()
            plain_send += 1e3 * (t1 - t0) / 3
            plain_drain += 1e3 * (time.perf_counter() - t1) / 3
        outs = [torch.empty_like(hi[0]) for _ in range(2)]

        def copies(hi=hi, lo=lo, outs=outs):
            outs[0].copy_(hi[0])
            outs[1].copy_(lo[0])

        library_ms = time_ms(copies, 50)
        for wrapper, ms, pms in (("ring_send", send_ms, plain_send),
                                 ("ring_drain", drain_ms, plain_drain)):
            key = _build.launch_key(wrapper, sname, hi[0])
            record(f"{wrapper}<{sname}{',' + BF16 if b16 else ''}>", wrapper,
                   sname, "remote.cu", TPU + "remote.py:136", ms, pms,
                   4 * meta["slab_bytes"], 0, library_ms, 4, shape,
                   per_step_peer.get(key, 0.0), dtype=BF16 if b16 else None)
            kernels_out[-1].update(
                shards_a_launch=1, unit_bytes=site.unit,
                blocks_a_chunk=site.blocks, nslots=site.nslots,
                region_bytes=site.region_bytes,
                timed_as="one shard's both directions, the 4-process "
                         "main path's launch")
        del hi, lo, outs
    remote.free_peer_regions()


def peer_ring_phase(counted, lines, main_launches, scratch):
    """Phase 5f: the ring across processes (ROADMAP B7).  Every PEER_RUNS
    run in one process (virtual devices: the in-card ring_exchange for the
    rdma runs), then as its processes on the card through phase 5d's
    machinery: each bit-equal to its one-process run (blocks, --log-every
    lines), the rdma runs carried by ring_send / ring_drain with one of each
    a process for every ring_exchange launch of the one-process run, every
    site drained; each one-process rdma run bit-equal to its stream twin;
    each rdma run's ms/step printed beside its gloo-host twin's (the same
    processes, the same launch) and the one-process run's, with both
    transports' host time a step call, and the processes' summed peaks
    (PyTorch's allocations plus the peer ring's regions), over the set-up
    (the initial fields) and over the time loop, each held at or under
    --mem-check's estimate.  With two cards or more the NCCL leg runs
    heat3d 2x2 with and without the ring, a card a process (the peer
    writes over NVLink); else it prints NOT RUN and why.  Returns the
    phase's lines of figures."""
    from mpi_cuda_process_tpu_torch import make_stencil
    from mpi_cuda_process_tpu_torch.utils import budget

    rows, nccl_note, mp = multiprocess_phase(
        counted, lines, main_launches, scratch, runs=PEER_RUNS,
        nccl_runs=PEER_NCCL, tag="peer_ring")
    for label in mp:
        if label.endswith("_rdma") or "_rdma_" in label:
            twin = label.replace("_rdma", "_stream")
            if mp[label]["fingerprints"] != mp[twin]["fingerprints"]:
                fail(f"peer_ring {label}: the one-process rdma run differs "
                     f"from its stream twin {twin}")
    spec = {r[0]: r for r in PEER_RUNS}
    by = {(r["label"], r["processes"], r["backend"]): r for r in rows}
    out = []
    for (label, procs, backend), row in by.items():
        if not (label.endswith("_rdma") or "_rdma_" in label):
            continue  # a gloo-host twin, or a launch's warm-up
        twin = by[(label.replace("_rdma", "_stream"), procs, backend)]
        _, _, stencil, grid, _, _, flags = spec[label]
        dtype = flags[flags.index("--dtype") + 1] if "--dtype" in flags \
            else None
        st = make_stencil(stencil, **({"dtype": dtype} if dtype else {}))
        mesh = tuple(int(v) for v in flags[1].split(","))
        est, parts = budget.estimate_run_bytes(
            st, grid, mesh=mesh, fuse=4, fuse_kind="stream",
            overlap="--overlap" in flags, exchange="rdma",
            shards_per_device=math.prod(mesh), processes=procs)
        regions = row["peer_ring_region_bytes"]
        peak = row["peak_bytes_all_processes"] + regions
        set_up = row["set_up_peak_bytes_all_processes"] + regions
        if max(peak, set_up) > est:
            fail(f"peer_ring {label} ({procs} processes): peak {peak} B "
                 f"over the time loop, {set_up} B over the set-up, above "
                 f"the estimate {est} B")
        line = {"label": label, "processes": procs, "backend": backend,
                "argv": row["argv"],
                "ms_per_step": row["ms_per_step"],
                "gloo_twin_ms_per_step": twin["ms_per_step"],
                "one_process_ms_per_step": row["one_process_ms_per_step"],
                "peer_ring_host_ms_per_step_call":
                    row["peer_ring_host_ms_per_step_call"],
                "gloo_twin_exchange_ms_per_step_call":
                    twin["exchange_ms_per_step_call"],
                "peer_ring_bytes_sent_per_step_call":
                    row["peer_ring_bytes_sent_per_step_call"],
                "ring_launches": {k: v for k, v in row["launches"].items()
                                  if k.startswith("ring_")},
                "sites": row["peer_ring_sites"],
                "peak_bytes_all_processes": peak,
                "set_up_peak_bytes_all_processes": set_up,
                "peer_ring_region_bytes": regions,
                "estimate_bytes": est,
                "peer_slot_term": [b for lb, b in parts
                                   if lb.startswith("peer ring")],
                "bit_equal_to_one_process": True,
                "bit_equal_to_gloo_twin": True, "drained": True}
        out.append(line)
        emit({"phase": "peer_ring_run", **line})
    return {"runs": out, "nccl": nccl_note}


def pipeline_checkpoint_phase(counted, lines, main_launches, scratch):
    """Phase 5e: the pipelined slab-carry exchange in one process (every
    PIPE_RUNS run with and without --pipeline, bit-equal, the same
    launches) and across processes (PIPE_MP_RUNS through phase 5d's
    machinery, each bit-equal to its one-process run, the two one-process
    runs bit-equal to each other), then the sharded checkpoint across
    processes: 4 processes of heat3d at MAIN on --mesh 2,2 killed by
    FAULT_INJECT=exchange:step=CK_KILL:sigkill on every rank, resumed as 2
    processes on --mesh 4 and as one unsharded process, both bit-equal to
    the uninterrupted run.  Returns the phase's figures."""
    import torch

    from mpi_cuda_process_tpu_torch import cli
    from mpi_cuda_process_tpu_torch.parallel import mesh as mesh_lib
    from mpi_cuda_process_tpu_torch.utils import checkpointing

    saved_virtual = os.environ.get(mesh_lib.VIRTUAL_DEVICES_ENV)
    out = {"pipeline": [], "pipeline_multiprocess": [], "checkpoint": {}}
    for label, stencil, grid, iters, flags in PIPE_RUNS:
        shards = math.prod(int(v) for v in flags[1].split(","))
        os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = str(shards)
        twin = {False: [], True: []}
        for pipe in (False, True, True, False):
            argv = ["--stencil", stencil, "--grid",
                    ",".join(map(str, grid)), "--iters", str(iters),
                    "--init", "pulse", *stencil_flags(stencil), *flags,
                    *(("--pipeline",) if pipe else ())]
            lines.clear()
            (fields, mcells), got = counted(
                lambda: cli.run(cli.config_from_args(argv)))
            if pipe and not any(ln.startswith("exchange: pipelined slab "
                                              "carry") for ln in lines):
                fail(f"pipeline {label}: the run logged no pipelined "
                     "exchange")
            mesh = fields[0].mesh
            twin[pipe].append({
                "fingerprints": {
                    f"{j}:{','.join(map(str, c))}": fingerprint(b)
                    for j, f in enumerate(fields)
                    for c, b in zip(mesh.local_coords(), f)},
                "launches": got,
                "ms_per_step": 1e3 * math.prod(grid) / (mcells * 1e6)})
            del fields, mesh
            torch.cuda.empty_cache()
        first = twin[False][0]
        for r in twin[True] + twin[False]:
            if r["fingerprints"] != first["fingerprints"]:
                fail(f"pipeline {label}: --pipeline changed the fields")
            if r["launches"] != first["launches"]:
                fail(f"pipeline {label}: launches {r['launches']} != "
                     f"{first['launches']}")
        row = {"label": label, "argv": " ".join(flags), "iters": iters,
               "ms_per_step": [r["ms_per_step"] for r in twin[True]],
               "ms_per_step_without": [r["ms_per_step"]
                                       for r in twin[False]],
               "order": "without, with, with, without",
               "launches": first["launches"], "bit_equal": True}
        out["pipeline"].append(row)
        emit({"phase": "pipeline_run", **row})
    if saved_virtual is not None:
        os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = saved_virtual

    rows, _, mp = multiprocess_phase(counted, lines, main_launches, scratch,
                                     runs=PIPE_MP_RUNS, nccl_runs=(),
                                     tag="pipeline_multiprocess")
    prints = [mp[r[0]]["fingerprints"] for r in PIPE_MP_RUNS]
    if any(p != prints[0] for p in prints):
        fail("pipeline across processes: the one-process runs with and "
             "without --pipeline differ")
    for row in rows:
        out["pipeline_multiprocess"].append(row)
        emit({"phase": "pipeline_multiprocess_run", **row})

    # the sharded checkpoint: kill, resume on 2 processes and on 1
    grid = ",".join(map(str, MAIN))
    base = ["--stencil", "heat3d", "--grid", grid, "--init", "pulse",
            "--iters", str(CK_ITERS), "--checkpoint-every", str(CK_EVERY),
            "--checkpoint-backend", "orbax", "--compute", "jnp"]
    ck = os.path.join(scratch, "ckpt_sharded")
    ck1 = os.path.join(scratch, "ckpt_sharded_unsharded")
    shutil.rmtree(ck, ignore_errors=True)
    shutil.rmtree(ck1, ignore_errors=True)
    os.environ.pop(mesh_lib.VIRTUAL_DEVICES_ENV, None)
    lines.clear()
    (ref, _), _ = counted(lambda: cli.run(cli.config_from_args(
        ["--stencil", "heat3d", "--grid", grid, "--init", "pulse",
         "--iters", str(CK_ITERS), "--compute", "jnp"])))
    want = fingerprint(ref[0])
    del ref
    torch.cuda.empty_cache()
    fault = f"exchange:step={CK_KILL}:sigkill"
    rcs, errs = _cli_processes(4, base + ["--mesh", "2,2",
                                          "--checkpoint-dir", ck],
                               {"FAULT_INJECT": fault})
    if rcs != [-9] * 4 or not all(f"firing '{fault}'" in e for e in errs):
        fail(f"checkpoint: the 4 processes did not all die at the fault: "
             f"{rcs}\n{errs[0][-2000:]}")
    if checkpointing.latest_step(ck) != CK_EVERY or \
            checkpointing.checkpoint_format(ck) != "dcp":
        fail(f"checkpoint: after the kill the newest is step "
             f"{checkpointing.latest_step(ck)}, not {CK_EVERY}")
    written = [_io_figures(e) for e in errs]
    shutil.copytree(ck, ck1)
    rcs2, errs2 = _cli_processes(2, base + ["--mesh", "4", "--resume",
                                            "--checkpoint-dir", ck])
    if rcs2 != [0, 0]:
        fail(f"checkpoint: the 2-process resume exited {rcs2}:\n"
             f"{errs2[0][-3000:]}")
    resumed2 = [_io_figures(e) for e in errs2]
    lines.clear()
    (fields, _), _ = counted(lambda: cli.run(cli.config_from_args(
        base + ["--resume", "--checkpoint-dir", ck1])))
    if fingerprint(fields[0]) != want:
        fail("checkpoint: the unsharded resume differs from the "
             "uninterrupted run")
    read1 = _io_figures("\n".join(lines))
    del fields
    torch.cuda.empty_cache()
    loaded, step, _ = checkpointing.load_any(
        ck, target_fields=(torch.empty(MAIN, device="cuda"),))
    if step != CK_ITERS or fingerprint(loaded[0]) != want:
        fail(f"checkpoint: the 2-process resume's step-{step} checkpoint "
             "differs from the uninterrupted run")
    del loaded
    torch.cuda.empty_cache()

    def rate(figs, which):
        rows = [f for f in figs if (f[0] == "read") == (which == "read")]
        return [{"step": f[0], "bytes": f[1], "seconds": f[2],
                 "GB_per_s": f[1] / f[2] / 1e9 if f[2] else None}
                for f in rows]

    out["checkpoint"] = {
        "grid": grid, "kill": fault, "every": CK_EVERY,
        "iters": CK_ITERS, "bit_equal_2_processes_mesh_4": True,
        "bit_equal_unsharded": True,
        "write_4_processes": [rate(w, "write") for w in written],
        "read_2_processes": [rate(r, "read") for r in resumed2],
        "write_2_processes": [rate(r, "write") for r in resumed2],
        "read_unsharded": rate(read1, "read"),
        "write_unsharded": rate(read1, "write")}
    emit({"phase": "sharded_checkpoint", **out["checkpoint"]})
    shutil.rmtree(ck, ignore_errors=True)
    shutil.rmtree(ck1, ignore_errors=True)
    if saved_virtual is not None:
        os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = saved_virtual
    return out


def auto_dispatch_phase(counted, lines, main_launches, scratch):
    """Phase 5g: the default ``--compute auto`` on the card.

    Each ``AUTO_RUNS`` run goes through ``cli.run`` as users run it
    (auto), with the explicit flags of the path the dispatch tables
    promise, on the plain path, and as users run it again (the first run
    pays the set-up; the second is the one timed).  The auto runs' launch
    counters must name the promised kernel and equal the explicit run's,
    the first auto run's fields must equal the explicit run's bit for bit,
    and the ms/step of each run is printed.  Then ``--debug-checks`` and
    ``--check-finite`` on a blow-up must raise naming the step that the
    plain step, driven by hand, first makes non-finite, and config 2's auto run with ``--dump-every``
    must write the state at each dump step (the native writer must build:
    ``native.available()``).  Returns the phase's rows."""
    import torch

    from mpi_cuda_process_tpu_torch import cli, driver
    from mpi_cuda_process_tpu_torch.parallel import mesh as mesh_lib
    from mpi_cuda_process_tpu_torch.utils import native
    from mpi_cuda_process_tpu_torch.utils.init import init_state

    if not native.available():
        fail("native.available() is false: g++ could not build "
             "native/stencilhost.cpp")
    rows = []

    def argv(stencil, grid, iters, flags):
        return ["--stencil", stencil, "--grid", ",".join(map(str, grid)),
                "--iters", str(iters), *flags]

    def promise(stencil, grid, iters, flags):
        """(explicit flags, launch-counter wrapper) of the path the tables
        promise an auto run, read from the tables themselves."""
        cfg = cli.config_from_args(argv(stencil, grid, iters, flags))
        st = cli._make_cfg_stencil(cfg)
        wins = cli._COMPUTE_FN_WINS.get(st.name, ())
        if cfg.mesh:
            if "mesh" in wins:
                return ("--compute", "pallas"), (
                    "whole2d" if st.ndim == 2 else
                    "zchunk_wave" if st.name == "wave3d" else "zchunk_heat")
            return ("--compute", "jnp"), None
        if st.ndim == 2:
            k = cli._AUTO_FULL_K.get(st.name)
            if k and iters % k == 0:
                return ("--fuse", str(k)), "fullgrid_step"
            if "single" in wins:
                return ("--compute", "pallas"), "whole2d"
            return ("--compute", "jnp"), None
        k = {torch.float32: cli._AUTO_FUSE_K,
             torch.bfloat16: cli._AUTO_FUSE_K_BF16}[st.dtype].get(st.name)
        if k and iters % k == 0:
            if cli._AUTO_FUSE_KIND.get(st.name) == "stream":
                return ("--fuse", str(k), "--fuse-kind", "stream"), \
                    "stream_step"
            return ("--fuse", str(k)), "fused_step"
        if st.name in cli._RAW_WINS:
            return ("--compute", "pallas"), {
                "wave3d": "raw_step_wave",
                "grayscott3d": "raw_step_grayscott"}.get(st.name,
                                                          "raw_step_heat")
        return ("--compute", "jnp"), None

    def blocks(fields):
        return [b for f in fields for b in (f if isinstance(f, list)
                                            else (f,))]

    for label, stencil, grid, iters, flags in AUTO_RUNS:
        if "--mesh" in flags:
            os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = str(math.prod(
                int(v) for v in flags[flags.index("--mesh") + 1]
                .split(",")))
        explicit, wrapper = promise(stencil, grid, iters, flags)
        out = {}
        # the first auto run pays the run's set-up; the second is timed
        for mode, extra in (("auto_first", ()), ("explicit", explicit),
                            ("plain", ("--compute", "jnp")), ("auto", ())):
            lines.clear()
            (fields, mcells), got = counted(lambda: cli.run(
                cli.config_from_args(argv(stencil, grid, iters,
                                          flags + extra))))
            driver.synchronize(fields)
            out[mode] = {"launches": got, "mcells_per_s": mcells,
                         "ms_per_step": 1e3 * math.prod(grid)
                         / (mcells * 1e6)}
            if mode == "auto_first":
                auto_blocks = blocks(fields)
                out[mode]["log"] = [ln for ln in lines
                                    if ln.startswith(("auto:", "compute:"))]
            elif mode == "explicit":
                if not all(torch.equal(a, b) for a, b in
                           zip(auto_blocks, blocks(fields))):
                    fail(f"auto {label}: fields differ from the explicit "
                         f"run {' '.join(explicit)}")
                del auto_blocks
            del fields
            torch.cuda.empty_cache()
        a, e = out["auto"]["launches"], out["explicit"]["launches"]
        if a != e or out["auto_first"]["launches"] != e:
            fail(f"auto {label}: launches {a} != the explicit run's {e}")
        if wrapper is None and a:
            fail(f"auto {label}: the plain path was promised, launches {a}")
        if wrapper is not None and (not a or any(
                not k.startswith(wrapper + "[") for k in a)):
            fail(f"auto {label}: launches {a}, promised {wrapper}")
        row = {"label": label, "stencil": stencil, "grid": list(grid),
               "iters": iters, "flags": list(flags),
               "promised": list(explicit), "wrapper": wrapper,
               "bit_equal_to_explicit": True, **{
                   f"{m}_{f}": out[m][f] for m in out
                   for f in ("ms_per_step", "launches")},
               "auto_log": out["auto_first"]["log"]}
        rows.append(row)
        emit({"phase": "auto_dispatch_run", **row})
        os.environ.pop(mesh_lib.VIRTUAL_DEVICES_ENV, None)

    # the sanitizers: the step the plain step first makes non-finite
    san = ["--stencil", "heat2d", "--grid", ",".join(map(str, BASE2D)),
           "--iters", str(SAN_ITERS), "--param", f"alpha={SAN_ALPHA}"]
    cfg = cli.config_from_args(san)
    st = cli._make_cfg_stencil(cfg)
    step = driver.make_step(st, cfg.grid)
    fields = init_state(st, cfg.grid, cfg.seed, cfg.density, device="cuda")
    bad = None
    for i in range(SAN_ITERS):
        fields = step(fields)
        if not bool(torch.isfinite(fields[0]).all()):
            bad = i
            break
    del fields
    if bad is None:
        fail(f"sanitizers: alpha={SAN_ALPHA} did not blow up in "
             f"{SAN_ITERS} steps")
    done = -(-(bad + 1) // SAN_EVERY) * SAN_EVERY
    want = {
        "debug_checks": f"field 0 non-finite after step {bad} (NaN/Inf "
                        "blow-up — check stability parameters)",
        "check_finite": f"field 0 became non-finite between steps "
                        f"{done - SAN_EVERY} and {done} (NaN/Inf blow-up "
                        "— check stability parameters)"}
    sanitizers = {"first_bad_step": bad}
    for name, extra in (("debug_checks", ("--debug-checks",
                                          "--log-every", "5")),
                        ("check_finite", ("--check-finite",
                                          str(SAN_EVERY)))):
        lines.clear()
        try:
            counted(lambda: cli.run(cli.config_from_args(san + list(extra))))
        except RuntimeError as e:
            if str(e) != want[name]:
                fail(f"sanitizers {name}: raised {e!r}, not {want[name]!r}")
            sanitizers[name] = str(e)
        else:
            fail(f"sanitizers {name}: the blow-up raised nothing")
        torch.cuda.empty_cache()
    emit({"phase": "auto_sanitizers", **sanitizers})

    # the dumps of config 2's auto run: the state at each dump step
    _, stencil, grid, iters, flags = AUTO_RUNS[1]
    ddir = os.path.join(scratch, "dumps")
    shutil.rmtree(ddir, ignore_errors=True)
    base = argv(stencil, grid, iters, flags)
    counted(lambda: cli.run(cli.config_from_args(
        base + ["--dump-every", str(DUMP_EVERY), "--dump-dir", ddir])))
    cfg = cli.maybe_auto_fuse(cli.config_from_args(base))
    st, step_fn, fields, _ = cli.build(cfg)
    unit = max(1, cfg.fuse)
    checked = []
    for n in range(iters // unit):
        fields = step_fn(fields)
        at = (n + 1) * unit
        if at % DUMP_EVERY:
            continue
        with open(os.path.join(ddir, f"step_{at:08d}.npy"), "rb") as fh:
            data = fh.read()
        arr, descr = native.host_array(fields[0])
        if not data.endswith(arr.tobytes()) or \
                f"'descr': '{descr}'" not in data[:128].decode("latin-1"):
            fail(f"dump at step {at} differs from the state at that step")
        checked.append(at)
    del fields
    shutil.rmtree(ddir, ignore_errors=True)
    if checked != list(range(DUMP_EVERY, iters + 1, DUMP_EVERY)):
        fail(f"dumps: checked steps {checked}")
    emit({"phase": "auto_dumps", "steps": checked, "fuse": cfg.fuse,
          "fuse_kind": cfg.fuse_kind, "native": True})
    return {"runs": rows, "sanitizers": sanitizers, "dumps": checked}


def ensemble_phase(counted, lines, main_launches, scratch):
    """Phase 5h: the ensemble axis on the card (ROADMAP A7).

    First each batched kernel on ENS_CHECK_N members: K4, K5 and K7 at
    every table kind, K8's streaming and tiled kinds (whole grid and a row
    shard), K10's three modes and K3 (whole grid and sharded mode), K6 and
    K9.  Each call must count one launch under its ",ensemble" key, equal
    the unbatched launches of its members bit for bit, and equal its plain
    version on the batch (bit for bit; K3/K6/K9's float32 heat and wave
    kinds within 1e-4: they reassociate taps).  Then each ENS_RUNS run
    through ``cli.run`` as users run it, with the device-memory peak held
    to ``--mem-check``'s estimate, and its members 0 and N-1 held bit for
    bit to the unbatched step run from the same member's init (seed + i,
    perturbed by ``init.perturb_member`` where the run perturbs), whose
    launches a step, times the ensemble groups, must equal the batch's
    (one launch a kernel and shard for all of a block's members).  Then
    the batch and its member N-1, each built again by ``cli.build``, timed
    by CUDA events after a warm-up chunk (``event_ms``): ms/step of the
    batch beside N times a member's.  Returns
    ``{"errs": {entry: max |d|}, "checked": [...], "runs": [...]}``."""
    import dataclasses
    import statistics

    import torch

    from mpi_cuda_process_tpu_torch import cli, driver, make_stencil
    from mpi_cuda_process_tpu_torch.ops.cuda import (fullgrid, fused,
                                                     kernels, streamfused)
    from mpi_cuda_process_tpu_torch.ops.stencil import k_step_margin
    from mpi_cuda_process_tpu_torch.parallel import mesh as mesh_lib
    from mpi_cuda_process_tpu_torch.parallel import stepper
    from mpi_cuda_process_tpu_torch.utils import budget
    from mpi_cuda_process_tpu_torch.utils import init as init_lib

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261022)
    n = ENS_CHECK_N
    views = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.int32: torch.int32}
    errs, checked = {}, []

    def members(st, shape):
        x = [torch.rand((n,) + tuple(shape), generator=gen, device=dev)
             for _ in range(st.num_fields)]
        if st.dtype == torch.int32:
            return tuple((t < 0.3).to(torch.int32) for t in x)
        return tuple(t.to(st.dtype) for t in x)

    def pick(x, i):
        if isinstance(x, torch.Tensor):
            return x[i].contiguous()
        return type(x)(pick(y, i) for y in x)

    def same(a, b):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.view(views[a.dtype]), b.view(views[b.dtype]))

    def first(x):
        return x if isinstance(x, torch.Tensor) else first(x[0])

    def hold(entry, counter, key, fn, plain, args, atol=0.0, calls=1):
        """``fn(*args)`` on the batch (each operand a tuple of batched
        fields, or a list of such tuples): ``calls`` launches under
        ``key``, member by member its own launches bit for bit, and within
        ``atol`` of ``plain(*args)`` (bit for bit at 0)."""
        counter.clear()
        got = fn(*args)
        torch.cuda.synchronize()
        if dict(counter) != {key: calls}:
            fail(f"{entry}: launches {dict(counter)}, expected {key}: "
                 f"{calls}")
        solo = [fn(*(pick(a, i) for a in args)) for i in range(n)]
        torch.cuda.synchronize()
        for i in range(n):
            if not all(same(g[i], s) for g, s in zip(got, solo[i])):
                fail(f"{entry}: member {i} differs from its own launch")
        ref = plain(*args)
        err = 0.0
        for g, r in zip(got, ref):
            if atol == 0.0 and not same(g, r):
                fail(f"{entry}: differs from the plain version")
            err = max(err, float((g.float() - r.float()).abs().max()))
        if err > atol:
            fail(f"{entry}: max|d| {err:.3e} > atol {atol:.1e}")
        errs[entry] = max(errs.get(entry, 0.0), err)
        checked.append({"kernel": entry, "members": n,
                        "shape": list(first(args).shape[1:]),
                        "max_abs_err": err, "atol": atol})

    def tag(st):
        return "" if st.dtype in (torch.float32, torch.int32) else \
            "," + str(st.dtype).replace("torch.", "")

    def check(wrapper, st, counter, fn, plain, args, atol=0.0, calls=1):
        name = f"{st.name}{tag(st)},ensemble"
        hold(f"{wrapper}<{name}>", counter, f"{wrapper}[{name}]", fn,
             plain, args, atol, calls)

    # K4, K5, K7: every table kind
    for name, dt in kernels.TILES:
        st = make_stencil(name, dtype=dt)
        h = st.halo
        shape = (300, 258) if st.ndim == 2 else (33, 35, 130)
        ins = members(st, tuple(s + 2 * h for s in shape))
        if name == "wave3d":
            ins = (ins[0], members(st, shape)[0])
        comp = kernels.make_pallas_compute(st, device=dev)
        wrapper = "whole2d" if st.ndim == 2 else (
            "zchunk_wave" if name == "wave3d" else "zchunk_heat")
        check(wrapper, st, kernels.launches,
              lambda f, comp=comp: comp(f)[:1],
              lambda f, st=st: st.update(f)[:1], (ins,))
    # K8: the streaming kind (guard frame) and the tiled kind (periodic),
    # the whole grid and one row shard's padded block
    for name, dt, k in (("heat2d", "float32", 8), ("heat2d", "bfloat16", 16),
                        ("life", "int32", 8), ("wave2d", "float32", 8),
                        ("grayscott2d", "float32", 8),
                        ("sor2d", "float32", 8)):
        st = make_stencil(name, dtype=dt)
        m = k_step_margin(st, k)
        shape = (200, 130)
        calls = -(-k // fullgrid._steps_per_launch(st))
        for periodic in (False, True) if name != "sor2d" else (False,):

            def plain(f, st=st, k=k, periodic=periodic):
                step = driver.make_step(st, shape, periodic=periodic)
                for _ in range(k):
                    f = step(f)
                return f

            def plain_pad(p, st=st, k=k, m=m, periodic=periodic):
                out = fused._plain_window_steps(
                    p, st, k, (64 - m, 0), (256, 130), periodic,
                    wrap_axes=(1,))
                return tuple(f[:, m:m + 64].contiguous() for f in out)

            check("fullgrid_step", st, fullgrid.launches,
                  lambda f, st=st, k=k, periodic=periodic:
                  fullgrid.fullgrid_step(f, st, k, periodic),
                  plain, (members(st, shape),), calls=calls)
            check("fullgrid_padded", st, fullgrid.launches,
                  lambda p, st=st, k=k, periodic=periodic:
                  fullgrid.fullgrid_padded(p, st, k, 256, 64, periodic),
                  plain_pad, (members(st, (64 + 2 * m, 130)),))
    # K10's three modes; K3 (whole grid, sharded mode), K6 and K9
    for name, dt, k in (("heat3d", "float32", 4), ("wave3d", "float32", 4),
                        ("grayscott3d", "float32", 4),
                        ("sor3d", "float32", 4), ("heat3d4th", "float32", 2),
                        ("advect3d", "float32", 4),
                        ("heat3d", "bfloat16", 8),
                        ("wave3d", "bfloat16", 8)):
        st = make_stencil(name, dtype=dt, **STENCIL_PARAMS.get(name, {}))
        m = k_step_margin(st, k)
        Lz, Ly, X = shape = (40, 36, 70)
        gshape, org = (3 * Lz, 2 * Ly, X), (Lz, Ly)
        core = members(st, shape)
        lo, hi = members(st, (m, Ly, X)), members(st, (m, Ly, X))
        ylo, yhi = members(st, (Lz, m, X)), members(st, (Lz, m, X))
        corners = [members(st, (m, m, X)) for _ in range(4)]
        zs, yz = (core, lo, hi), (core, lo, hi, ylo, yhi, corners)
        check("stream_step", st, streamfused.launches,
              lambda f, st=st, k=k: streamfused.stream_step(f, st, k),
              lambda f, st=st, k=k: fused.plain_steps(f, st, k), (core,))
        check("stream_zslab", st, streamfused.launches,
              lambda *a, st=st, k=k: streamfused.stream_zslab(
                  *a, st, k, gshape[0], Lz),
              lambda *a, st=st, k=k: fused.plain_zslab(
                  *a, st, k, gshape[0], Lz), zs)
        check("stream_yzslab", st, streamfused.launches,
              lambda *a, st=st, k=k: streamfused.stream_yzslab(
                  *a, st, k, gshape, org),
              lambda *a, st=st, k=k: fused.plain_yzslab(
                  *a, st, k, gshape, org), yz)
        if fused.margin_of(st, k) is not None:
            atol = 1e-4 if dt == "float32" and name in (
                "heat3d", "heat3d27", "heat3d4th", "wave3d") else 0.0
            padded = members(st, (Lz + 2 * m, Ly + 2 * m, X))
            check("fused_step", st, fused.launches,
                  lambda f, st=st, k=k: fused.fused_step(f, st, k),
                  lambda f, st=st, k=k: fused.plain_steps(f, st, k),
                  (core,), atol)
            check("fused_step_padded", st, fused.launches,
                  lambda p, st=st, k=k: fused.fused_step_padded(
                      p, st, k, gshape, org),
                  lambda p, st=st, k=k: fused.plain_step_padded(
                      p, st, k, gshape, org), (padded,), atol)
            check("fused_zslab", st, fused.launches,
                  lambda *a, st=st, k=k: fused.fused_zslab(
                      *a, st, k, gshape[0], Lz),
                  lambda *a, st=st, k=k: fused.plain_zslab(
                      *a, st, k, gshape[0], Lz), zs, atol)
            check("fused_yzslab", st, fused.launches,
                  lambda *a, st=st, k=k: fused.fused_yzslab(
                      *a, st, k, gshape, org),
                  lambda *a, st=st, k=k: fused.plain_yzslab(
                      *a, st, k, gshape, org), yz, atol)
            del padded
        del core, lo, hi, ylo, yhi, corners, zs, yz
        torch.cuda.empty_cache()
    emit({"phase": "ensemble_kernels", "checked": len(checked),
          "max_abs_err": errs})

    # the CLI runs
    rows = []
    strip = ",ensemble]"

    def per_step(launches, calls):
        """launches a call, the ring's counted by call (its keys name the
        slab shape, which a batch flattens)."""
        out = {}
        for key, v in launches.items():
            key = "ring_exchange" if key.startswith("ring_") else \
                key.replace(strip, "]")
            out[key] = out.get(key, 0) + v / calls
        return out

    def event_ms(run_cfg):
        """ms/step of ``run_cfg``'s step by CUDA events: each of
        ENS_TIMED chunks of its iterations, after a warm-up chunk, from
        the fields of ``cli.build``'s init; (median, chunks)."""
        _, step_fn, fields, _ = cli.build(run_cfg)
        runner = driver.make_runner(step_fn,
                                    run_cfg.iters // max(1, run_cfg.fuse))
        fields = runner(fields)  # warm-up chunk, outside the clock
        torch.cuda.synchronize()
        chunks = []
        for _ in range(ENS_TIMED):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fields = runner(fields)
            e1.record()
            torch.cuda.synchronize()
            chunks.append(e0.elapsed_time(e1) / run_cfg.iters)
        del fields, runner, step_fn
        torch.cuda.empty_cache()
        return statistics.median(chunks), chunks

    for (label, stencil, grid, iters, nm, flags, vdev,
         expect) in ENS_RUNS:
        if vdev:
            os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = str(vdev)
        else:
            os.environ.pop(mesh_lib.VIRTUAL_DEVICES_ENV, None)
        argv = ["--stencil", stencil, "--grid", ",".join(map(str, grid)),
                "--iters", str(iters), "--ensemble", str(nm), *flags]
        cfg = cli.config_from_args(argv)
        estimate = []
        check_budget = budget.check_budget

        def spy(*a, **kw):
            out = check_budget(*a, **kw)
            estimate.append(out[0])
            return out

        budget.check_budget = spy
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            (fields, mcells), got = counted(lambda: cli.run(cfg))
            driver.synchronize(fields)
        finally:
            budget.check_budget = check_budget
        peak = torch.cuda.max_memory_allocated() - held
        if not estimate:
            fail(f"ensemble {label}: --mem-check priced nothing")
        if peak > estimate[-1]:
            fail(f"ensemble {label}: peak {peak} B above the estimate "
                 f"{estimate[-1]} B")
        for key in expect:
            if not got.get(key):
                fail(f"ensemble {label}: {key} launched no time "
                     f"({got})")
        cells = math.prod(grid)
        unit = max(1, cfg.fuse)
        cli_ms = 1e3 * nm * cells / (mcells * 1e6)
        out = stepper.gather_fields(fields) if stepper.is_sharded(fields) \
            else fields
        del fields
        single = dataclasses.replace(cfg, ensemble=0, ensemble_mesh=0,
                                     ensemble_perturb=0.0)
        for i in (0, nm - 1):
            st, step_fn, init, _ = cli.build(dataclasses.replace(
                single, seed=cfg.seed + i))
            if cfg.ensemble_perturb:
                whole = init_lib.perturb_member(
                    init_lib.init_state(st, cfg.grid, cfg.seed + i,
                                        cfg.density, kind=cfg.init,
                                        periodic=cfg.periodic, device=dev),
                    st, i, cfg.seed, cfg.ensemble_perturb, cfg.periodic)
                init = stepper.shard_fields(whole, init[0].mesh, st.ndim) \
                    if stepper.is_sharded(init) else whole
                del whole
            member, solo = counted(lambda: driver.run_simulation(
                st, driver.Donated(init), iters // unit, step_fn=step_fn))
            driver.synchronize(member)
            del init
            if stepper.is_sharded(member):
                member = stepper.gather_fields(member)
            if not all(same(o[i], f) for o, f in zip(out, member)):
                fail(f"ensemble {label}: member {i} differs from the "
                     "unbatched run of its init")
            # one launch a kernel and shard for all of its members: the
            # batch's launches are one member's times the ensemble groups
            groups = max(1, cfg.ensemble_mesh)
            if per_step(got, iters) != {
                    key: groups * v
                    for key, v in per_step(solo, iters).items()}:
                fail(f"ensemble {label}: launches a step {got} against "
                     f"{groups} x one member's {solo}")
            del member
        del out, step_fn
        torch.cuda.empty_cache()
        batch_ms, batch_chunks = event_ms(cfg)
        solo_ms, solo_chunks = event_ms(dataclasses.replace(
            single, seed=cfg.seed + nm - 1))
        row = {"label": label, "stencil": stencil, "grid": list(grid),
               "iters": iters, "members": nm, "flags": list(flags),
               "cli_ms_per_step": cli_ms, "mcells_per_s": mcells,
               "ms_per_step": batch_ms, "ms_per_step_chunks": batch_chunks,
               "member_ms_per_step": solo_ms,
               "member_ms_per_step_chunks": solo_chunks,
               "n_times_member_ms": nm * solo_ms,
               "batch_over_n_members": batch_ms / (nm * solo_ms),
               "launches": got,
               "launches_per_step": per_step(got, iters),
               "peak_bytes": peak, "estimate_bytes": estimate[-1],
               "members_checked": [0, nm - 1], "bit_equal": True}
        rows.append(row)
        emit({"phase": "ensemble_run", **row})
    os.environ.pop(mesh_lib.VIRTUAL_DEVICES_ENV, None)
    return {"errs": errs, "checked": checked, "runs": rows}


def groups_phase(counted, lines, main_launches, scratch):
    """Phase 5i: device groups on the card (ROADMAP A7).

    Each ``GROUP_RUNS`` run through ``cli.run`` under both transports:
    the launches must name the kernels the groups' modes route to, the
    device-memory peak must stay at or under ``--mem-check``'s coupled
    estimate (the groups on the card summed), and the two transports'
    assembled fields must be equal bit for bit.  A same-physics split must
    equal its monolithic twin's fields bit for bit (the twin run for the
    same number of steps: a round is k of them); the heterogeneous demo
    must equal the same runner whose groups step through the plain
    versions of their kernels (k plain sharded steps a round), within
    1e-4 (K3's float32 heat and wave kinds reassociate taps).  Then each
    run's runner, built again by ``cli.build_coupled``, is timed by CUDA
    events (``GROUP_TIMED`` chunks of ``GROUP_CHUNK`` rounds after a
    warm-up chunk), with the exchange alone, and the twin's step the same
    way.  Returns ``{"runs": [...], "launches": {key: n}}``: the launches
    of every groups run of the phase."""
    import dataclasses
    import statistics

    import torch

    from mpi_cuda_process_tpu_torch import cli, driver
    from mpi_cuda_process_tpu_torch.parallel import mesh as mesh_lib
    from mpi_cuda_process_tpu_torch.parallel import stepper
    from mpi_cuda_process_tpu_torch.utils import budget

    smi = nvidia_smi()
    views = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    glaunch, rows = {}, []

    def same(a, b):
        return all(x.dtype == y.dtype and x.shape == y.shape
                   and torch.equal(x.view(views[x.dtype]),
                                   y.view(views[y.dtype]))
                   for x, y in zip(a, b))

    def gathered(fields):
        return tuple(stepper.gather_fields((f,), device="cpu")[0]
                     for f in fields)

    def chunks_ms(fn, n):
        """(median, chunks) ms of one call of ``fn`` by CUDA events:
        ``n`` calls a chunk after a warm-up chunk."""
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(GROUP_TIMED):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(n):
                fn()
            e1.record()
            torch.cuda.synchronize()
            out.append(e0.elapsed_time(e1) / n)
        return statistics.median(out), out

    for label, stencil, grid, spec, vdev, twin, expect in GROUP_RUNS:
        os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = str(vdev)
        base = ["--stencil", stencil, "--grid", ",".join(map(str, grid)),
                "--iters", str(GROUP_ROUNDS), "--groups", spec]
        held, runs = {}, {}
        for transport in ("device_put", "collective"):
            cfg = cli.config_from_args(base + ["--group-transport",
                                               transport])
            estimate = []
            check = budget.check_coupled_budget

            def spy(*a, **kw):
                out = check(*a, **kw)
                estimate.append(out[0])
                return out

            budget.check_coupled_budget = spy
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            try:
                (fields, mcells), got = counted(lambda: cli.run(cfg))
            finally:
                budget.check_coupled_budget = check
            peak = torch.cuda.max_memory_allocated() - before
            if not estimate:
                fail(f"groups {label}: --mem-check priced nothing")
            if peak > estimate[-1]:
                fail(f"groups {label} ({transport}): peak {peak} B above "
                     f"the coupled estimate {estimate[-1]} B")
            for key in expect:
                if not got.get(key):
                    fail(f"groups {label}: {key} launched no time ({got})")
            for key, n in got.items():
                glaunch[key] = glaunch.get(key, 0) + n
            held[transport] = fields
            runs[transport] = {"mcells_per_s": mcells, "peak_bytes": peak,
                               "estimate_bytes": estimate[-1],
                               "launches": got}
        if not same(held["device_put"], held["collective"]):
            fail(f"groups {label}: the collective transport differs from "
                 "device_put")
        cfg = cli.config_from_args(base)
        plans, runner, _ = cli.build_coupled(cfg)
        k = plans[0].spec.fuse_k
        row = {"label": label, "groups": spec, "base_grid": list(grid),
               "rounds": GROUP_ROUNDS, "steps_per_round": k,
               "group_grids": [list(p.grid) for p in plans],
               "kinds": runner.step_kinds(),
               "cell_updates_per_round": runner.cell_updates_per_round(),
               "refined_everywhere_over_coupled": (
                   max(p.spec.ratio for p in plans) ** len(grid)
                   * math.prod(grid) / runner.cell_updates_per_round()),
               "transports": runs, "transports_bit_equal": True,
               "card": smi}
        if twin is not None:
            tcfg = cli.config_from_args(
                ["--stencil", stencil, "--grid", ",".join(map(str, grid)),
                 "--iters", str(GROUP_ROUNDS * k), *twin])
            os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = "4"
            (tfields, _), _ = counted(lambda: cli.run(tcfg))
            tfields = gathered(tfields)
            if not same(held["device_put"], tfields):
                fail(f"groups {label}: the split differs from its "
                     "monolithic twin")
            row["monolithic_bit_equal"] = True
            del tfields
            os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = str(vdev)
        else:
            # the same runner through the plain versions of its kernels:
            # k plain sharded steps a round
            _, plain, _ = cli.build_coupled(cfg)

            def plain_round(fs, p, msh, k=k):
                step = stepper.make_sharded_step(p.stencil, msh, p.grid)
                for _ in range(k):
                    fs = step(fs)
                return fs

            plain._runners = [
                (lambda fs, p=p, msh=msh: plain_round(fs, p, msh))
                for p, msh in zip(plans, plain.meshes)]
            _, none = counted(lambda: plain.run(GROUP_ROUNDS))
            if none:
                fail(f"groups {label}: the plain run launched {none}")
            runner.run(GROUP_ROUNDS)
            if not same(runner.assemble(), held["device_put"]):
                fail(f"groups {label}: build_coupled's runner differs from "
                     "cli.run's")
            err = 0.0
            for g, (a, b) in enumerate(zip(runner.fields, plain.fields)):
                for x, y in zip(gathered(a), gathered(b)):
                    err = max(err, float((x.float() - y.float()).abs()
                                         .max()))
            if not err <= 1e-4:
                fail(f"groups {label}: max|d| {err:.3e} against the plain "
                     "versions > 1e-4")
            row["plain_max_abs_err"] = err
            del plain
            runner = cli.build_coupled(cfg)[1]
        del held
        torch.cuda.empty_cache()
        # timing: each transport's round, the exchange alone, launches a
        # round; then the monolithic twin's k steps
        for transport in ("device_put", "collective"):
            if transport == "collective":
                del runner
                torch.cuda.empty_cache()
                runner = cli.build_coupled(dataclasses.replace(
                    cfg, group_transport=transport))[1]
            ms, ms_chunks = chunks_ms(runner.step_round, GROUP_CHUNK)
            ex_ms, ex_chunks = chunks_ms(runner.exchange, GROUP_CHUNK)
            _, got = counted(lambda: runner.run(GROUP_CHUNK))
            runs[transport].update(
                ms_per_round=ms, ms_per_round_chunks=ms_chunks,
                exchange_ms=ex_ms, exchange_ms_chunks=ex_chunks,
                exchange_share=ex_ms / ms,
                launches_per_round={key: n / GROUP_CHUNK
                                    for key, n in got.items()})
        del runner
        torch.cuda.empty_cache()
        if twin is not None:
            os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = "4"
            tcfg = cli.config_from_args(
                ["--stencil", stencil, "--grid", ",".join(map(str, grid)),
                 "--iters", str(k), *twin])
            _, step_fn, fields, _ = cli.build(tcfg)
            box = [fields]

            def twin_round():
                box[0] = step_fn(box[0])

            row["monolithic_ms_per_round"], row["monolithic_chunks"] = \
                chunks_ms(twin_round, GROUP_CHUNK)
            row["round_over_monolithic"] = (
                runs["device_put"]["ms_per_round"]
                / row["monolithic_ms_per_round"])
            del box, fields, step_fn
            torch.cuda.empty_cache()
        row["collective_over_device_put"] = (
            runs["collective"]["ms_per_round"]
            / runs["device_put"]["ms_per_round"])
        rows.append(row)
        emit({"phase": "groups_run", **row})
    os.environ.pop(mesh_lib.VIRTUAL_DEVICES_ENV, None)
    return {"runs": rows, "launches": glaunch}


# The observability layer (phase 5j, ROADMAP A8's first part): config 3
# (heat3d 1024^3 --mesh 2,2 on 4 virtual devices) with every obs flag,
# each run beside its obs-off twin.
OBS_BASE = ("--stencil", "heat3d", "--grid", "1024,1024,1024", "--iters",
            "40", "--init", "pulse", "--mesh", "2,2", "--fuse", "4")
OBS_STREAM = OBS_BASE + ("--fuse-kind", "stream")
OBS_PROFILED = OBS_BASE + ("--fuse-kind", "padfree", "--overlap")
OBS_MP_ITERS = "16"
OBS_ALTERNATIONS = 3
OBS_CALLS = 10  # step calls a timed chunk (40 steps)


def obs_phase(counted, lines, main_launches, scratch):
    """Phase 5j: the observability layer on the card (ROADMAP A8).

    (a) config 3 ``--fuse 4 --fuse-kind stream`` (K10 YZSLAB), 40
    iterations, with ``--telemetry --health --halo-audit 2 --anomaly``
    beside its obs-off twin: final fields bit-equal, the same launch
    counters, the log valid event by event, every health record HEALTHY,
    every audit clean, no anomaly, the peak (the recorder's, boundaries
    included) at or under ``--mem-check``'s estimate; then by CUDA events
    in alternation ms/step with obs off and on (the step and the
    recorder's synchronize and record a call, as the CLI's loop with an
    observer runs it), ms a health check and ms an audit pass.
    (b) (a) with ``--exchange rdma --halo-audit 1``: the audit's
    re-exchange launches ``ring_exchange`` under its own 1-row-slab keys,
    the step's keys equal the twin's, every pass clean (backend
    ``cuda-ring``), fields bit-equal; ms an audit pass.  (c) (a) as a
    child process with ``FAULT_INJECT=numerics:step=20:nan`` and
    ``--log-every 4 --checkpoint-every 16``: it exits nonzero with
    SimulationDiverged at step 20, the DIVERGED record names field 0 and
    one non-finite cell, the newest checkpoint is step 16's, and the
    flight-recorder bundle is valid.  (d) ``--profile`` on the K9
    ``--overlap`` kind: the attribution is available, with device-busy,
    interior and exchange ms, the overlap efficiency and the idle share.
    (e) config 3 as 4 processes (gloo-host) with ``--telemetry
    --health``: a log a process (process_index 0-3), the health records
    identical across processes and to the one-process run's.  (f) phase
    5i's config 3 split with ``--telemetry --health``: ``group_chunk``
    events and HEALTHY records for every group.  Also the heartbeat
    probe's verdict and its second context's bytes on the card.  Returns
    ``{"runs": {...}, "launches": {key: n}}``."""
    import statistics

    import torch

    from mpi_cuda_process_tpu_torch import cli, driver
    from mpi_cuda_process_tpu_torch.obs import flightrec, heartbeat
    from mpi_cuda_process_tpu_torch.obs import health as health_lib
    from mpi_cuda_process_tpu_torch.obs import runtime as runtime_lib
    from mpi_cuda_process_tpu_torch.obs import trace as trace_lib
    from mpi_cuda_process_tpu_torch.parallel import mesh as mesh_lib
    from mpi_cuda_process_tpu_torch.utils import budget

    smi = nvidia_smi()
    out, olaunch = {"card": smi}, {}
    d = os.path.join(scratch, "obs")
    os.makedirs(d, exist_ok=True)
    os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = "4"

    def add(got):
        for key, n in got.items():
            olaunch[key] = olaunch.get(key, 0) + n

    def records(path):
        manifest, events = trace_lib.validate_log(path)
        if manifest["provenance"].get("nvidia_smi") != smi:
            fail(f"obs: manifest names {manifest['provenance']} not {smi}")
        return events

    def same(a, b):
        views = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        return all(len(x) == len(y) and all(
            torch.equal(p.view(views[p.dtype]), q.view(views[q.dtype]))
            for p, q in zip(x, y)) for x, y in zip(a, b))

    def run(argv, label):
        """(fields, launches, allocated at the start, estimate, the
        allocator's peak above the start) of one cli.run of ``argv`` on
        the card."""
        estimate = []
        check = budget.check_budget

        def spy(*a, **kw):
            res = check(*a, **kw)
            estimate.append(res[0])
            return res

        budget.check_budget = spy
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            (fields, _), got = counted(
                lambda: cli.run(cli.config_from_args(list(argv))))
        finally:
            budget.check_budget = check
        torch.cuda.synchronize()
        if not estimate:
            fail(f"obs {label}: --mem-check priced nothing")
        add(got)
        return (fields, got, before, estimate[-1],
                torch.cuda.max_memory_allocated() - before)

    def checked_log(path, label, audits_backend=None):
        events = records(path)
        health = [e for e in events if e["kind"] == "health"]
        audits = [e for e in events if e["kind"] == "halo_audit"]
        if not health or any(e["verdict"] != "HEALTHY" for e in health):
            fail(f"obs {label}: health records {health[-1:]}")
        if audits_backend is not None and (not audits or any(
                not a["ok"] or a["backend"] != audits_backend
                for a in audits)):
            fail(f"obs {label}: audit records {audits[-1:]}")
        found = [e for e in events if e["kind"] == "anomaly"]
        if found:
            fail(f"obs {label}: anomaly findings {found}")
        summary = [e for e in events if e["kind"] == "summary"]
        if not summary:
            fail(f"obs {label}: no summary event")
        return events, health, audits, summary[-1]

    # ---- (a) and (b): the full run and the ring under the auditor --------
    for label, argv, audit_k, backend in (
            ("stream", OBS_STREAM, "2", "ppermute"),
            ("stream_rdma", OBS_STREAM + ("--exchange", "rdma"), "1",
             "cuda-ring")):
        log = os.path.join(d, f"{label}.jsonl")
        twin, tgot, _, _, twin_peak = run(argv, label + "_twin")
        obs_argv = argv + ("--telemetry", log, "--health", "--halo-audit",
                           audit_k, "--anomaly")
        fields, got, before, estimate, _ = run(obs_argv, label)
        if not same(twin, fields):
            fail(f"obs {label}: fields differ from the obs-off twin")
        del twin, fields
        extra = {k: n for k, n in got.items() if k not in tgot}
        step_keys = {k: n for k, n in got.items() if k in tgot}
        if step_keys != tgot:
            fail(f"obs {label}: the step's launches {step_keys} differ "
                 f"from the twin's {tgot}")
        if label == "stream" and extra:
            fail(f"obs {label}: launches beyond the twin's: {extra}")
        # the audit's slabs are one row deep on their axis
        if label == "stream_rdma" and (not extra or any(
                not k.startswith("ring_exchange[")
                or "1" not in k[len("ring_exchange["):-1].split("x")
                for k in extra)):
            fail(f"obs {label}: the audit's ring launches {extra}")
        events, health, audits, summary = checked_log(log, label, backend)
        peak = summary["runtime"]["memory_peak_bytes"] - before
        if peak > estimate:
            fail(f"obs {label}: peak {peak} B above the estimate "
                 f"{estimate} B")
        out[label] = {"health_records": len(health),
                      "audits": len(audits), "launches": got,
                      "audit_launches": extra, "peak_bytes": peak,
                      "twin_peak_bytes": twin_peak,
                      "estimate_bytes": estimate,
                      "log_events": len(events)}

    # timing by CUDA events: the step alone (obs off) and the step with
    # the recorder's synchronize and record a call (obs on), alternated;
    # then a health check and an audit pass, each on its own
    for label, argv in (("stream", OBS_STREAM),
                        ("stream_rdma", OBS_STREAM + ("--exchange",
                                                      "rdma"))):
        cfg = cli.config_from_args(list(argv))
        st, step_fn, fields, _ = cli.build(cfg)
        box = [fields]
        rec = runtime_lib.RuntimeRecorder(step_unit=4, cuda=True)
        mon = health_lib.HealthMonitor(st)
        aud = health_lib.HaloAuditor(st, fields[0].mesh, cfg.grid,
                                     exchange=cfg.exchange)

        def call_off():
            box[0] = step_fn(box[0])

        def call_on():
            rec.begin_chunk()
            t0 = time.perf_counter()
            box[0] = driver.synchronize(step_fn(box[0]))
            rec.record_chunk(1, time.perf_counter() - t0)

        def timed(fn, n):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            for _ in range(n):
                fn()
            e1.record()
            torch.cuda.synchronize()
            return e0.elapsed_time(e1) / n

        timed(call_off, 2)
        timed(lambda: mon.check(0, box[0]), 1)
        timed(lambda: aud.audit(box[0], 0), 1)
        offs, ons, checks, passes = [], [], [], []
        for _ in range(OBS_ALTERNATIONS):
            offs.append(timed(call_off, OBS_CALLS) / 4)
            ons.append(timed(call_on, OBS_CALLS) / 4)
            checks.append(timed(lambda: mon.check(0, box[0]), 3))
            passes.append(timed(lambda: aud.audit(box[0], 0), 3))
        if not aud.audit(box[0], 0)["ok"]:
            fail(f"obs {label}: the timed audit found a mismatch")
        if label == "stream":
            # where a check's time goes: one block's slab-wise
            # reduction, and each of its reductions over the whole block
            b = box[0][0][0]
            out[label]["health_split_ms"] = {
                name: timed(fn, 3) for name, fn in (
                    ("block_slabwise", lambda: health_lib._block_stats(
                        b, 0, True)),
                    ("amin", lambda: torch.amin(b)),
                    ("amax", lambda: torch.amax(b)),
                    ("sum_float64", lambda: torch.sum(
                        b, dtype=torch.float64)),
                    ("sum_float32", lambda: torch.sum(b)),
                    ("isfinite_count", lambda: torch.isfinite(b).sum()))}
            out[label]["health_split_block"] = list(b.shape)
            del b
        chunk_ms = 4 * statistics.median(offs)
        out[label].update(
            ms_per_step_off=offs, ms_per_step_on=ons,
            on_over_off=statistics.median(ons) / statistics.median(offs),
            health_ms=checks, audit_ms=passes,
            health_share_of_4step_chunk=statistics.median(checks)
            / chunk_ms)
        del box, fields, step_fn, mon, aud
        torch.cuda.empty_cache()

    # ---- (c) an injected numerics fault, in a child ----------------------
    ck = os.path.join(d, "fault_ck")
    log = os.path.join(d, "fault.jsonl")
    argv = OBS_STREAM + ("--telemetry", log, "--health", "--halo-audit",
                         "2", "--anomaly", "--log-every", "4",
                         "--checkpoint-every", "16", "--checkpoint-dir", ck)
    rcs, errs = _cli_processes(1, list(argv), {
        mesh_lib.VIRTUAL_DEVICES_ENV: "4",
        "FAULT_INJECT": "numerics:step=20:nan"})
    if rcs[0] == 0 or "SimulationDiverged" not in errs[0] or \
            "DIVERGED at step 20" not in errs[0]:
        fail(f"obs fault: rc {rcs[0]}, stderr {errs[0][-1500:]}")
    _, events = trace_lib.validate_log(log)
    bad = [e for e in events if e["kind"] == "health"][-1]
    if bad["verdict"] != "DIVERGED" or bad["step"] != 20 or \
            bad["fields"][0]["nonfinite"] != 1 or \
            "field 0" not in (bad["reason"] or ""):
        fail(f"obs fault: the DIVERGED record {bad}")
    with open(os.path.join(ck, "meta.json")) as fh:
        newest = json.load(fh)["step"]
    if newest != 16:
        fail(f"obs fault: the newest checkpoint is step {newest}")
    bundle = flightrec.read_bundle(os.path.join(d, "fault.bundle.json"))
    if bundle["verdict"] != "DIVERGED":
        fail(f"obs fault: bundle verdict {bundle['verdict']}")
    out["fault"] = {"rc": rcs[0], "diverged_step": bad["step"],
                    "newest_checkpoint": newest,
                    "bundle_events": len(bundle["events"])}
    shutil.rmtree(ck, ignore_errors=True)

    # ---- (d) the profiler on K9 --overlap --------------------------------
    pdir = os.path.join(d, "profile")
    log = os.path.join(d, "profile.jsonl")
    run(OBS_PROFILED + ("--profile", pdir, "--telemetry", log), "profile")
    att = [e for e in records(log) if e["kind"] == "profile"]
    if not att or att[0]["attribution"] != "ok":
        fail(f"obs profile: {att}")
    att = att[0]
    # K9 --overlap exchanges every step: a classifier that counted its
    # halo copies as interior work would read comm 0 and still say "ok"
    if not (att["comm_us"] > 0 and att["overlap_efficiency"] is not None
            and att["compute_us"] < att["device_busy_us"]
            and sum(att["comm_events"].values()) > 0
            and 0.0 <= (att.get("idle_share") or -1.0) <= 1.0):
        fail(f"obs profile: no exchange attributed on K9 --overlap: {att}")
    out["profile"] = {k: att.get(k) for k in (
        "profiled_chunk", "n_device_events", "device_busy_us",
        "compute_us", "comm_us", "comm_events", "exposed_comm_us",
        "overlap_efficiency", "idle_share", "chunk_wall_us",
        "device_span_us")}
    shutil.rmtree(pdir, ignore_errors=True)

    # ---- (e) 4 processes over gloo-host ----------------------------------
    mp = list(OBS_STREAM)
    mp[mp.index("--iters") + 1] = OBS_MP_ITERS
    log = os.path.join(d, "mp.jsonl")
    rcs, errs = _cli_processes(4, mp + ["--telemetry", log, "--health"])
    if any(rcs):
        fail(f"obs 4 processes: rcs {rcs}, {errs[rcs.index(max(rcs))][-1500:]}")
    one = os.path.join(d, "one.jsonl")
    run(mp + ["--telemetry", one, "--health"], "one_process")

    def health_of(path):
        return [{k: v for k, v in e.items() if k != "t"}
                for e in records(path) if e["kind"] == "health"]

    want = health_of(one)
    stem, ext = os.path.splitext(log)
    for r in range(4):
        path = log if r == 0 else f"{stem}.p{r}{ext}"
        manifest, _ = trace_lib.validate_log(path)
        if manifest["provenance"]["process_index"] != r or \
                manifest["provenance"]["process_count"] != 4:
            fail(f"obs 4 processes: manifest of {path}: "
                 f"{manifest['provenance']}")
        if health_of(path) != want:
            fail(f"obs 4 processes: process {r}'s health records differ "
                 "from the one-process run's")
    out["multiprocess"] = {"processes": 4, "health_records": len(want)}

    # ---- (f) groups -------------------------------------------------------
    label, stencil, grid, spec, vdev, _, expect = GROUP_RUNS[0]
    os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = str(vdev)
    log = os.path.join(d, "groups.jsonl")
    gargv = ["--stencil", stencil, "--grid", ",".join(map(str, grid)),
             "--iters", str(GROUP_ROUNDS), "--groups", spec, "--telemetry",
             log, "--health"]
    _, got = counted(lambda: cli.run(cli.config_from_args(gargv)))
    add(got)
    events = records(log)
    names = sorted({e["group"] for e in events
                    if e["kind"] == "group_chunk"})
    health = [e for e in events if e["kind"] == "health"]
    if len(names) != 2 or sorted({e["group"] for e in health}) != names \
            or any(e["verdict"] != "HEALTHY" for e in health):
        fail(f"obs groups: groups {names}, health {health[-2:]}")
    out["groups"] = {"label": label, "groups": names,
                     "group_chunks": sum(e["kind"] == "group_chunk"
                                         for e in events),
                     "health_records": len(health)}

    # ---- the heartbeat probe on the card ---------------------------------
    v = heartbeat.probe_verdict(timeout_s=60.0)
    if v["verdict"] != "CARD_HEALTHY":
        fail(f"obs heartbeat probe: {v}")
    out["heartbeat_probe"] = {"verdict": v["verdict"],
                              "context_bytes": v.get("context_bytes"),
                              "wall_s": [p.get("wall_s")
                                         for p in v["probes"]]}
    os.environ.pop(mesh_lib.VIRTUAL_DEVICES_ENV, None)
    shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "obs_run", **out})
    return {"runs": out, "launches": olaunch}


# The live console and the campaign ledger (phase 5k, ROADMAP A8's second
# part): config 3 (heat3d 1024^3 --mesh 2,2 --fuse 4 --fuse-kind stream on 4
# virtual devices, K10 YZSLAB) served (--serve 0) beside its telemetry-only
# twin, long enough (SERVE_ITERS, a chunk every SERVE_LOG_EVERY steps) for
# the console to poll it mid-run; 4 processes at 512^3 with --serve 0.
SERVE_ITERS = "400"
SERVE_LOG_EVERY = "40"
SERVE_ARGV = ("--stencil", "heat3d", "--grid", "1024,1024,1024", "--iters",
              SERVE_ITERS, "--init", "pulse", "--mesh", "2,2", "--fuse",
              "4", "--fuse-kind", "stream", "--log-every", SERVE_LOG_EVERY)
SERVE_MP_ARGV = ("--stencil", "heat3d", "--grid", "512,512,512", "--iters",
                 "32", "--init", "pulse", "--mesh", "2,2", "--fuse", "4",
                 "--fuse-kind", "stream", "--log-every", "8", "--serve",
                 "0")
SERVE_CALLS = 50  # step calls a timed chunk (200 steps, about 1 s)
SERVE_SCRAPE_S = 0.25  # the timed scraper's period (the poller's too)


class Scraper:
    """A thread that scrapes a live console until it goes away: it finds
    the URL in the ``serve`` event of ``log`` (or takes ``url``), then
    reads ``/metrics`` and ``/status.json`` every ``period`` seconds,
    keeping each scrape's events total, step total, hosts rows and
    ``/metrics`` seconds, and the newest ``/metrics`` text."""

    def __init__(self, log=None, url=None, period=0.05, timeout=600.0):
        import threading

        self.log, self.url, self.period = log, url, period
        self.timeout = timeout
        self.scrapes, self.text, self.status = [], "", {}
        self.error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="smoke-scraper", daemon=True)
        self._thread.start()

    def _find_url(self):
        try:
            with open(self.log) as fh:
                for line in fh:
                    rec = json.loads(line)
                    if rec.get("kind") == "serve":
                        return rec["url"]
        except (OSError, ValueError):
            pass
        return None

    def _loop(self):
        import urllib.request

        deadline = time.monotonic() + self.timeout
        try:
            while self.url is None and not self._stop.is_set():
                if time.monotonic() > deadline:
                    raise TimeoutError(f"no serve event in {self.log}")
                self.url = self._find_url()
                time.sleep(0.02)
            while not self._stop.is_set():
                try:
                    t0 = time.perf_counter()
                    with urllib.request.urlopen(self.url + "/metrics",
                                                timeout=10) as r:
                        text = r.read().decode()
                    secs = time.perf_counter() - t0
                    with urllib.request.urlopen(self.url + "/status.json",
                                                timeout=10) as r:
                        status = json.loads(r.read())
                except OSError:
                    return  # the run ended and closed its console
                self.text, self.status = text, status

                def metric(name):
                    for ln in text.splitlines():
                        if ln.startswith(name + " "):
                            return float(ln.split()[-1])
                    return 0.0

                self.scrapes.append({
                    "events": metric("obs_events_total"),
                    "steps": metric("obs_steps_total"),
                    "hosts": len(status.get("hosts") or ()),
                    "done": status.get("summary") is not None,
                    "metrics_s": secs})
                self._stop.wait(self.period)
        except Exception as e:  # noqa: BLE001 — read by the phase
            self.error = e

    def stop(self):
        self._stop.set()
        self._thread.join(30.0)
        if self.error is not None:
            fail(f"serve: the scraper failed: {self.error!r}")
        return self.scrapes


def serve_phase(counted, lines, main_launches, scratch):
    """Phase 5k: the live console and the campaign ledger on the card
    (ROADMAP A8's second part).

    (a) config 3 K10 (``SERVE_ARGV``) through ``cli.run`` with ``--serve
    0 --telemetry`` beside its telemetry-only twin: final fields
    bit-equal, the step's launch counters equal, exactly one ``serve``
    event, at least two scrapes from a thread while the run goes with the
    step and ``obs_events_total`` rising, no ``obs-serve*`` thread left;
    then ms/step by CUDA events, telemetry-only and served (the console
    polling the growing log, a scraper every 0.25 s), in 3 alternations,
    and each ``/metrics`` scrape's seconds; the same served/twin pair
    with ``--exchange rdma`` (``ring_exchange`` launched).  (b) (a)'s log ingested by
    ``python -m mpi_cuda_process_tpu_torch.obs.ledger ingest`` into a
    ledger under build/chip_smoke/: one ``ok`` row, backend ``cuda``,
    its provenance naming the card and its power limit; ``best`` prints
    it; a served ``--anomaly`` rerun is seeded from it (the monitor's
    ``best_source`` is the row's ``source``), finds no ``roofline_gap``
    and serves ``obs_ledger_best_known{...,backend="cuda"}``;
    ``flightrec._best_known_for`` returns the row.  (c) 4 processes
    (gloo-host) at 512^3 with ``--serve 0``: process 0's ``/status.json``
    has 4 ``hosts`` rows and the other processes bind nothing.  Returns
    ``{"runs": {...}, "launches": {key: n}}`` (the served runs')."""
    import dataclasses
    import statistics
    import threading

    import torch

    from mpi_cuda_process_tpu_torch import cli, driver, obs
    from mpi_cuda_process_tpu_torch.obs import anomaly as anomaly_lib
    from mpi_cuda_process_tpu_torch.obs import flightrec
    from mpi_cuda_process_tpu_torch.obs import ledger as ledger_lib
    from mpi_cuda_process_tpu_torch.obs import serve as serve_lib
    from mpi_cuda_process_tpu_torch.obs import trace as trace_lib
    from mpi_cuda_process_tpu_torch.parallel import mesh as mesh_lib

    smi = nvidia_smi()
    out, slaunch = {"card": smi}, {}
    d = os.path.join(scratch, "serve")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    ledger = os.path.join(d, "ledger.jsonl")
    saved_env = {k: os.environ.get(k) for k in (
        "OBS_LEDGER_PATH", "OBS_TELEMETRY_DIR", mesh_lib.VIRTUAL_DEVICES_ENV)}
    os.environ.update({"OBS_LEDGER_PATH": ledger, "OBS_TELEMETRY_DIR": d,
                       mesh_lib.VIRTUAL_DEVICES_ENV: "4"})

    def add(got):
        for key, n in got.items():
            slaunch[key] = slaunch.get(key, 0) + n

    def same(a, b):
        return all(len(x) == len(y) and all(
            torch.equal(p.view(torch.int32), q.view(torch.int32))
            for p, q in zip(x, y)) for x, y in zip(a, b))

    def alive():
        return [t.name for t in threading.enumerate()
                if t.name.startswith("obs-serve") and t.is_alive()]

    def rising(scrapes, label):
        mid = [s for s in scrapes if not s["done"]]
        if len(mid) < 2 or mid[-1]["events"] <= mid[0]["events"] or \
                mid[-1]["steps"] <= mid[0]["steps"]:
            fail(f"serve {label}: no rise over the mid-run scrapes {mid}")
        return mid

    try:
        # ---- (a) the served run beside its telemetry-only twin -----------
        for label, argv in (("run", SERVE_ARGV),
                            ("run_rdma", SERVE_ARGV + ("--exchange",
                                                       "rdma"))):
            twin_log = os.path.join(d, f"{label}_twin.jsonl")
            (twin, _), tgot = counted(lambda: cli.run(cli.config_from_args(
                list(argv) + ["--telemetry", twin_log])))
            log = os.path.join(d, f"{label}.jsonl")
            scraper = Scraper(log)
            try:
                (fields, _), got = counted(lambda: cli.run(
                    cli.config_from_args(list(argv) + [
                        "--telemetry", log, "--serve", "0"])))
            finally:
                scrapes = scraper.stop()
            add(got)
            if not same(twin, fields):
                fail(f"serve {label}: fields differ from the "
                     "telemetry-only twin")
            del twin, fields
            if got != tgot:
                fail(f"serve {label}: the served run's launches {got} "
                     f"differ from the twin's {tgot}")
            if alive():
                fail(f"serve {label}: threads left after the run: "
                     f"{alive()}")
            _, events = trace_lib.validate_log(log)
            serves = [e for e in events if e["kind"] == "serve"]
            if len(serves) != 1:
                fail(f"serve {label}: {len(serves)} serve events")
            mid = rising(scrapes, label)
            out[label] = {
                "launches": got, "scrapes": len(scrapes),
                "mid_run": len(mid),
                "events_seen": [mid[0]["events"], mid[-1]["events"]],
                "steps_seen": [mid[0]["steps"], mid[-1]["steps"]],
                # each scrape's [steps the console had seen, /metrics ms]
                "metrics_ms_at_step": [[s["steps"], 1e3 * s["metrics_s"]]
                                       for s in scrapes],
                "summary_mcells_per_s": [e["mcells_per_s"] for e in events
                                         if e["kind"] == "summary"][0]}
        if not any(k.startswith("ring_exchange[")
                   for k in out["run_rdma"]["launches"]):
            fail(f"serve run_rdma: no ring_exchange launch in "
                 f"{out['run_rdma']['launches']}")
        log = os.path.join(d, "run.jsonl")
        tgot = out["run"]["launches"]

        # ms/step by CUDA events: the step with the recorder's record a
        # call into a live log (the CLI's loop with an observer), alone
        # and with the console polling that log and a scraper reading it
        cfg = cli.config_from_args(list(SERVE_ARGV))
        st, step_fn, fs, _ = cli.build(cfg)
        box = [fs]
        del fs
        tlog = os.path.join(d, "timed.jsonl")
        session = obs.open_session(tlog, tool="cli",
                                   run=dataclasses.asdict(cfg),
                                   step_unit=4, with_heartbeat=False)
        rec = session.recorder

        def call():
            rec.begin_chunk()
            t0 = time.perf_counter()
            box[0] = driver.synchronize(step_fn(box[0]))
            rec.record_chunk(1, time.perf_counter() - t0)

        def timed(n):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            for _ in range(n):
                call()
            e1.record()
            torch.cuda.synchronize()
            return e0.elapsed_time(e1) / n / 4

        timed(2)
        offs, ons, scrape_ms = [], [], []
        try:
            for _ in range(OBS_ALTERNATIONS):
                offs.append(timed(SERVE_CALLS))
                server = serve_lib.serve_run(tlog, poll_s=SERVE_SCRAPE_S)
                sc = Scraper(url=server.url, period=SERVE_SCRAPE_S)
                try:
                    ons.append(timed(SERVE_CALLS))
                finally:
                    scrape_ms += [1e3 * s["metrics_s"] for s in sc.stop()]
                    server.close()
        finally:
            session.finish()
            session.close()
        if alive():
            fail(f"serve timing: threads left: {alive()}")
        out["timing"] = {
            "ms_per_step_telemetry": offs, "ms_per_step_served": ons,
            "served_over_telemetry": statistics.median(ons)
            / statistics.median(offs),
            "metrics_ms": sorted(scrape_ms), "calls": SERVE_CALLS}
        del box, step_fn
        torch.cuda.empty_cache()

        # ---- (b) the ledger ------------------------------------------------
        env = dict(os.environ, PYTHONPATH=HERE)
        mod = [sys.executable, "-m", f"{PKG}.obs.ledger", "--ledger",
               ledger]
        res = subprocess.run(mod + ["ingest", log], capture_output=True,
                             text=True, cwd=HERE, env=env, timeout=120)
        if res.returncode != 0 or "1 rows appended" not in res.stdout:
            fail(f"serve ledger ingest: {res.stdout} {res.stderr[-1500:]}")
        rows = ledger_lib.read_rows(ledger)
        if len(rows) != 1 or rows[0]["status"] != "ok":
            fail(f"serve ledger: rows {rows}")
        row = rows[0]
        prov = row["provenance"]
        if row["key"]["backend"] != "cuda" or prov["nvidia_smi"] != smi \
                or prov["device_kind"] != torch.cuda.get_device_name(0):
            fail(f"serve ledger: the row's key {row['key']} and "
                 f"provenance {prov}")
        bk = ledger_lib.baseline_key(row)
        res = subprocess.run(mod + ["best"], capture_output=True,
                             text=True, cwd=HERE, env=env, timeout=120)
        best_lines = [ln for ln in res.stdout.splitlines()
                      if ln.startswith(bk + " ")]
        if res.returncode != 0 or len(best_lines) != 1 or \
                row["source"] not in best_lines[0]:
            fail(f"serve ledger best: {res.stdout} {res.stderr[-1500:]}")
        monitors = []
        monitor_cls = anomaly_lib.AnomalyMonitor

        class Kept(monitor_cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                monitors.append(self)

        alog = os.path.join(d, "anomaly.jsonl")
        anomaly_lib.AnomalyMonitor = Kept
        scraper = Scraper(alog)
        try:
            (_, _), got = counted(lambda: cli.run(cli.config_from_args(
                list(SERVE_ARGV) + ["--telemetry", alog, "--serve", "0",
                                    "--anomaly"])))
        finally:
            anomaly_lib.AnomalyMonitor = monitor_cls
            scraper.stop()
        add(got)
        if got != tgot:
            fail(f"serve anomaly: launches {got} differ from {tgot}")
        if len(monitors) != 1 or monitors[0].best_source != row["source"] \
                or monitors[0].best_value != row["value"]:
            fail(f"serve anomaly: seeded from "
                 f"{[(m.best_source, m.best_value) for m in monitors]}, "
                 f"not {row['source']}")
        _, events = trace_lib.validate_log(alog)
        gaps = [e for e in events if e["kind"] == "anomaly"
                and e.get("anomaly") == "roofline_gap"]
        if gaps:
            fail(f"serve anomaly: roofline_gap findings {gaps}")
        want = (f'obs_ledger_best_known{{backend="cuda",'
                f'label="{row["label"]}",unit="Mcells/s"}}')
        served = [ln for ln in scraper.text.splitlines()
                  if ln.startswith(want + " ")]
        if len(served) != 1 or float(served[0].split()[-1]) != row["value"]:
            fail(f"serve anomaly: the console served no {want} line")
        manifest, _ = trace_lib.read_log(log)
        got_row = flightrec._best_known_for(manifest)
        if got_row is None or got_row["key_id"] != row["key_id"] or \
                got_row["source"] != row["source"]:
            fail(f"serve flightrec: best_known {got_row}")
        out["ledger"] = {
            "baseline_key": bk, "value": row["value"], "unit": row["unit"],
            "provenance": prov,
            "anomaly_best_source_matches": True,
            "anomaly_findings": sum(e["kind"] == "anomaly"
                                    for e in events),
            "served_line": served[0]}

        # ---- (c) 4 processes, process 0 serving ---------------------------
        mlog = os.path.join(d, "mp.jsonl")
        scraper = Scraper(mlog, period=0.05)
        try:
            rcs, errs = _cli_processes(4, list(SERVE_MP_ARGV) + [
                "--telemetry", mlog], {
                "OBS_LEDGER_PATH": ledger, "OBS_TELEMETRY_DIR": d,
                "FAULT_INJECT": "exchange:step=16:sleep:1000"})
        finally:
            scrapes = scraper.stop()
        if any(rcs):
            fail(f"serve 4 processes: rcs {rcs}, "
                 f"{errs[rcs.index(max(rcs))][-1500:]}")
        hosts = max((s["hosts"] for s in scrapes), default=0)
        rows4 = (scraper.status or {}).get("hosts") or []
        if hosts != 4 or sorted(r["process_index"] for r in rows4) != \
                [0, 1, 2, 3]:
            fail(f"serve 4 processes: hosts rows {hosts}, "
                 f"{[r.get('key') for r in rows4]}")
        if "serving at" not in errs[0] or any(
                "serving at" in e for e in errs[1:]):
            fail("serve 4 processes: a process other than 0 served")
        stem, ext = os.path.splitext(mlog)
        for r in range(1, 4):
            _, ev = trace_lib.validate_log(f"{stem}.p{r}{ext}")
            if any(e["kind"] == "serve" for e in ev):
                fail(f"serve 4 processes: process {r} wrote a serve event")
        out["multiprocess"] = {
            "processes": 4, "hosts_rows": hosts,
            "aggregate": (scraper.status or {}).get("aggregate"),
            "scrapes": len(scrapes)}
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    shutil.rmtree(d, ignore_errors=True)
    emit({"phase": "serve_run", **out})
    return {"runs": out, "launches": slaunch}


# The cost model, the launch checks and --supervise (phase 5l, ROADMAP A6
# and A8's third part).  (a) CM_RUNS through cli.run with --telemetry:
# config 3 (heat3d 1024^3 --mesh 2,2 --fuse 4 on 4 virtual devices) as K10,
# K9 --overlap and K10 --exchange rdma, config 2 (heat3d 256^3) and config
# 1 (heat2d 512^2) under the default --compute auto; (c) --supervise on
# SUP_ARGV (config 3's K10 command at 512^3: a child's start on the card
# takes seconds, and the phase keeps to 90 s).
CM_ITERS = "64"
CM_LOG_EVERY = "16"
CM_CONFIG3 = ("--stencil", "heat3d", "--grid", "1024,1024,1024", "--init",
              "pulse", "--mesh", "2,2", "--fuse", "4")
CM_RUNS = (
    ("config3_stream", CM_CONFIG3 + ("--fuse-kind", "stream")),
    ("config3_padfree_overlap", CM_CONFIG3 + ("--fuse-kind", "padfree",
                                              "--overlap")),
    ("config3_rdma", CM_CONFIG3 + ("--fuse-kind", "stream", "--exchange",
                                   "rdma")),
    ("config2", ("--stencil", "heat3d", "--grid", "256,256,256", "--init",
                 "pulse")),
    ("config1", ("--stencil", "heat2d", "--grid", "512,512")),
)
L2_BYTES = 50e6  # the H100's L2: a field past it is priced by HBM alone
CM_ENSEMBLE_GRID = (256, 256, 256)  # (b)'s --ensemble 4 step
CM_GROUPS_GRID = (254, 128, 128)  # (b)'s --groups round: 2 x (127 + 1)
SUP_ARGV = ("--stencil", "heat3d", "--grid", "512,512,512", "--init",
            "pulse", "--mesh", "2,2", "--fuse", "4", "--fuse-kind",
            "stream", "--iters", "40", "--log-every", "4",
            "--checkpoint-every", "8")
# the child heartbeat's STALLED threshold: above a child's longest silent
# phase (its first chunk: K10's first launches, about 10 s on the card)
SUP_STALL_AFTER_S = "15"
# where phase 5l runs: the card (a rehearsal on the CPU sets "cpu" and
# shrinks the grids)
CM_DEVICE = "cuda"


def costmodel_phase(counted, lines, main_launches, scratch, p5k=None):
    """Phase 5l: the cost model, the launch checks and --supervise on the
    card (ROADMAP A6 and A8's third part).

    (a) each CM_RUNS case through ``cli.run`` with ``--telemetry``: one
    ``costmodel`` event whose counts equal the run's own exchange (the
    in-process transport's bytes a pass and shard, the ``ring_exchange``
    launches a pass) and one pass of the built step recorded
    (``utils/launchcheck.py``: shifts x 2 = ppermute rounds, bytes, ring
    launches); an rdma run's ``rdma_crosscheck`` matching; the console's
    ``obs_roofline_gap_ratio`` (steady p50 ms/step over the overlapped
    prediction) at least 1 for every case whose fields pass the 50 MB L2,
    printed for the others.  (b) the launch checks on recorded passes:
    K9 ``--overlap`` and K10 ``--overlap --pipeline`` (the interior on the
    main stream between the side stream's post and its wait, the
    pipelined body's rounds), K10 ``--exchange rdma``, an ``--ensemble 4``
    step, a ``--groups`` round under ``--group-transport collective``.
    (c) ``--supervise`` on SUP_ARGV, three supervised runs at once (two as
    ``python -m`` processes, one in this process): an injected hang at
    step 24 killed on its STALLED verdict, a SIGKILL at step 24 seen dead,
    each resumed from step 16 and finished bit-equal to an unsupervised
    twin; a permanent hang giving up with ``--max-restarts 1``, exit 1,
    the bundle's ``tunnel`` the card probe's OK.  Returns ``{"runs", "checks",
    "supervise", "launches"}``."""
    import dataclasses

    import numpy as np
    import torch

    from mpi_cuda_process_tpu_torch import cli, driver
    from mpi_cuda_process_tpu_torch.obs import metrics as metrics_lib
    from mpi_cuda_process_tpu_torch.obs import trace as trace_lib
    from mpi_cuda_process_tpu_torch.parallel import halo
    from mpi_cuda_process_tpu_torch.parallel import mesh as mesh_lib
    from mpi_cuda_process_tpu_torch.parallel import stepper
    from mpi_cuda_process_tpu_torch.resilience import supervisor as sup
    from mpi_cuda_process_tpu_torch.utils import checkpointing
    from mpi_cuda_process_tpu_torch.utils import launchcheck as lc

    smi = nvidia_smi()
    dev = torch.device(CM_DEVICE)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    on = ["--device", CM_DEVICE]
    out = {"card": smi, "runs": {}, "checks": {}, "supervise": {}}
    claunch = {}
    d = os.path.join(scratch, "costmodel")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    saved_env = {k: os.environ.get(k) for k in (
        "OBS_LEDGER_PATH", "OBS_TELEMETRY_DIR", mesh_lib.VIRTUAL_DEVICES_ENV,
        "OBS_STALL_AFTER_S", "FAULT_INJECT", "FAULT_HANG_S")}
    os.environ.update({"OBS_LEDGER_PATH": os.path.join(d, "ledger.jsonl"),
                       "OBS_TELEMETRY_DIR": d,
                       mesh_lib.VIRTUAL_DEVICES_ENV: "4"})
    transport = halo.default_transport(mesh_lib.make_mesh((1,), [dev]))

    def add(got):
        for key, n in got.items():
            claunch[key] = claunch.get(key, 0) + n

    def gauge(text, name):
        for ln in text.splitlines():
            if ln.startswith(name + " "):
                return float(ln.split()[-1])
        fail(f"costmodel: no {name} gauge")

    def record_pass(step_fn, fs):
        with lc.record() as rec:
            driver.synchronize(step_fn(fs))
        return rec.records

    try:
        # ---- (a) the costmodel event against the run ----------------------
        for label, argv in CM_RUNS:
            t0 = time.perf_counter()
            log = os.path.join(d, f"{label}.jsonl")
            cfg = cli.config_from_args(list(argv) + on + [
                "--iters", CM_ITERS, "--log-every", CM_LOG_EVERY,
                "--telemetry", log])
            before = transport.stats["bytes"]
            (fields, _), got = counted(lambda: cli.run(cfg))
            moved = transport.stats["bytes"] - before
            del fields
            add(got)
            manifest, events = trace_lib.validate_log(log)
            costs = [e for e in events if e["kind"] == "costmodel"]
            if len(costs) != 1:
                fail(f"costmodel {label}: {len(costs)} costmodel events")
            cost = costs[0]
            rm = metrics_lib.RunMetrics()
            for r in [manifest] + events:
                rm.ingest(r)
            text = rm.registry.to_prometheus()
            pred = gauge(text, "obs_predicted_ms_per_step_overlapped")
            gap = gauge(text, "obs_roofline_gap_ratio")
            p50 = rm.status()["throughput"]["steady_ms_per_step_p50"]
            roof = cost["roofline"]
            st = cli._make_cfg_stencil(cfg)
            field_bytes = math.prod(cfg.grid) * st.dtype.itemsize \
                * st.num_fields
            gated = field_bytes > L2_BYTES
            if gated and gap < 1.0:
                fail(f"costmodel {label}: measured {p50} ms/step under the "
                     f"roofline's {pred} (gap {gap})")
            if roof["basis"]["card"] not in ("H100 SXM", "H100 PCIe",
                                             "H100 NVL", "H200 SXM"):
                fail(f"costmodel {label}: priced for {roof['basis']}")
            # the recorded pass of the same step (built anew)
            bcfg = cli.maybe_auto_fuse(dataclasses.replace(cfg,
                                                           telemetry=None))
            passes = int(CM_ITERS) // max(1, bcfg.fuse)
            _, step_fn, fs, _ = cli.build(bcfg)
            recs = record_pass(step_fn, fs)
            rec = lc.exchange_counts(recs)
            comm = cost["comm"]
            rings = sum(n for k, n in got.items()
                        if k.startswith("ring_exchange["))
            row = {"predicted_ms_per_step_overlapped": pred,
                   "predicted_ms_per_step_serial": gauge(
                       text, "obs_predicted_ms_per_step_serial"),
                   "measured_ms_per_step_p50": p50, "gap": gap,
                   "fields_bytes": field_bytes, "gated": gated,
                   "shards_per_card": roof["basis"]["shards_per_card"],
                   "link": roof["basis"]["link"], "recorded": rec,
                   "transport_bytes": moved, "ring_launches": rings,
                   "fuse": bcfg.fuse}
            if comm is None:
                if rec["posts"] or rings or moved:
                    fail(f"costmodel {label}: an unsharded run exchanged "
                         f"({rec}, {rings} rings, {moved} bytes)")
            else:
                shards = roof["basis"]["shards_per_card"]
                calls = comm.get("rdma_exchange_calls_per_pass", 0)
                want = {"ppermute_rounds": comm["ppermute_rounds_per_pass"],
                        "ici_bytes": comm["ici_bytes_per_pass"],
                        "ring_calls": calls}
                if {k: rec[k] for k in want} != want:
                    fail(f"costmodel {label}: recorded {rec}, the event "
                         f"prices {want}")
                ring_mode = comm["exchange"] == "rdma"
                if moved != (0 if ring_mode else passes * shards
                             * comm["ici_bytes_per_pass"]):
                    fail(f"costmodel {label}: the transport moved {moved} "
                         f"bytes in {passes} passes of {shards} shards")
                # the launch counters count on the card (the CPU runs the
                # plain versions; a rehearsal there skips them)
                card = dev.type == "cuda"
                if card and rings != passes * calls:
                    fail(f"costmodel {label}: {rings} ring launches for "
                         f"{passes} passes of {calls}")
                if ring_mode:
                    cc = cost.get("rdma_crosscheck") or {}
                    if card and cc.get("match") is not True:
                        fail(f"costmodel {label}: rdma_crosscheck {cc}")
                    row["rdma_crosscheck"] = cc
                    # (b) the rdma launch check on the same pass
                    out["checks"]["k10_rdma"] = lc.assert_rdma_step_structure(
                        recs, calls)
                if "overlap" in label:
                    # (b) K9 --overlap: the interior between the side
                    # stream's post and its wait, on another CUDA stream
                    out["checks"]["k9_overlap"] = \
                        lc.assert_interior_overlaps_exchange(recs)
            del step_fn, fs, recs
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            row["seconds"] = round(time.perf_counter() - t0, 3)
            out["runs"][label] = row
            emit({"phase": "costmodel_run", "label": label, "card": smi,
                  **row})
        k10 = out["runs"]["config3_stream"]["measured_ms_per_step_p50"]
        out["config3_k10_ms_per_step"] = {
            "phase_5l_chunk_p50": k10,
            "phase_5k_ms_per_step_telemetry":
                (p5k or {}).get("timing", {}).get("ms_per_step_telemetry")}

        # ---- (b) the launch checks on the card ------------------------------
        t0 = time.perf_counter()
        pcfg = cli.config_from_args(list(CM_CONFIG3) + on + [
            "--fuse-kind", "stream", "--overlap", "--pipeline", "--iters",
            "4"])
        st, pipelined, fs, _ = cli.build(pcfg)
        plain = stepper.make_sharded_temporal_step(
            st, fs[0].mesh, pcfg.grid, 4, kind="stream", overlap=True,
            device=dev)
        rep = lc.assert_pipeline_body_structure(pipelined, plain, fs, True)
        rep["plain"] = lc.assert_interior_overlaps_exchange(
            record_pass(plain, fs))
        out["checks"]["k10_overlap_pipeline"] = rep
        del pipelined, plain, fs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["checks"]["ensemble4"] = lc.check_ensemble_structure(
            "heat3d", CM_ENSEMBLE_GRID, (2, 2, 1), 4, 4, "stream",
            device=dev)
        os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = "8"
        out["checks"]["groups_collective"] = \
            lc.check_group_transport_structure(
                "heat3d@0-3,heat3d@4-7", CM_GROUPS_GRID, device=dev,
                n_devices=8)
        os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = "4"
        out["checks"]["seconds"] = round(time.perf_counter() - t0, 3)
        emit({"phase": "launch_checks", "card": smi, **out["checks"]})

        # ---- (c) --supervise ------------------------------------------------
        t0 = time.perf_counter()
        (twin, _), got = counted(lambda: cli.run(cli.config_from_args(
            list(SUP_ARGV) + on)))
        add(got)
        twin = stepper.gather_fields(twin, device="cpu")
        os.environ.update({"OBS_STALL_AFTER_S": SUP_STALL_AFTER_S,
                           "FAULT_HANG_S": "90"})

        def sup_argv(tag, max_restarts):
            tel = os.path.join(d, f"{tag}.jsonl")
            return tel, list(SUP_ARGV) + on + [
                "--checkpoint-dir", os.path.join(d, f"ck_{tag}"),
                "--telemetry", tel, "--supervise", "--max-restarts",
                str(max_restarts), "--restart-backoff", "0.2",
                "--supervise-stall-s", "60"]

        def trail(tel):
            """Each attempt's seconds and resume step, the restart reasons,
            and the seconds from each kill (its restart event) to the
            relaunched child's resume event."""
            _, sevents = trace_lib.validate_log(
                sup.sibling_path(tel, "supervisor"))
            attempts = sorted(
                ({"attempt": e["attrs"]["attempt"],
                  "seconds": round(e["dur_s"], 3),
                  "resumed_from_step": e["attrs"].get("resumed_from_step")}
                 for e in sevents if e["kind"] == "span"
                 and e["name"] == "attempt"), key=lambda a: a["attempt"])
            restarts = [e for e in sevents if e["kind"] == "restart"]
            for i, e in enumerate(restarts):
                _, cev = trace_lib.read_log(
                    sup.sibling_path(tel, f"attempt{i + 1}"))
                resumed = [c["t"] for c in cev if c["kind"] == "resume"]
                attempts[i + 1]["kill_to_resume_s"] = (
                    round(resumed[0] - e["t"], 3) if resumed else None)
            return attempts, [e["reason"] for e in restarts]

        def kinds(tel, n):
            """The attempts' event kinds, for a failure's message."""
            return [[e["kind"] for e in trace_lib.read_log(
                sup.sibling_path(tel, f"attempt{i}"))[1]][-12:]
                for i in range(n)]

        # a hang and a SIGKILL at step 24, each a supervised CLI process of
        # its own (its own FAULT_INJECT), beside the permanent hang
        # supervised in this process (the longest of the three)
        procs = {}
        for tag, spec in (("wedge", "exchange:step=24:hang"),
                          ("sigkill", "exchange:step=24:sigkill")):
            tel, argv = sup_argv(tag, 2)
            with open(os.path.join(d, f"{tag}.out"), "w") as fh:
                procs[tag] = (tel, subprocess.Popen(
                    [sys.executable, "-m", PKG, *argv],
                    env=dict(os.environ, PYTHONPATH=HERE,
                             FAULT_INJECT=spec),
                    cwd=HERE, stdout=fh, stderr=subprocess.STDOUT))
        rcs = {}
        try:
            os.environ["FAULT_INJECT"] = "exchange:step=8:always:hang"
            gtel, argv = sup_argv("give_up", 1)
            rcs["give_up"] = sup.run_supervised(cli.config_from_args(argv))
            os.environ.pop("FAULT_INJECT")
            for tag, (_, proc) in procs.items():
                rcs[tag] = proc.wait(timeout=300)
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for tag, reason in (("wedge", "heartbeat verdict"),
                            ("sigkill", "child exited")):
            tel = procs[tag][0]
            attempts, restarts = trail(tel)
            if rcs[tag] != 0 or [a["resumed_from_step"]
                                 for a in attempts] != [None, 16] or \
                    not restarts[0].startswith(reason):
                fail(f"supervise {tag}: rc {rcs[tag]}, attempts "
                     f"{attempts}, restarts {restarts}, events "
                     f"{kinds(tel, len(attempts))}")
            fields, step, _ = checkpointing.load_any(
                os.path.join(d, f"ck_{tag}"))
            if step != 40 or not all(
                    np.array_equal(np.asarray(a), b.numpy())
                    for a, b in zip(fields, twin)):
                fail(f"supervise {tag}: the resumed run's final fields "
                     "differ from the unsupervised twin's")
            out["supervise"][tag] = {
                "attempts": attempts, "restarts": restarts,
                "fingerprint": fingerprint(torch.from_numpy(
                    np.asarray(fields[0]))),
                "twin_fingerprint": fingerprint(twin[0])}
            del fields
        del twin
        from mpi_cuda_process_tpu_torch.obs import flightrec

        bundle = flightrec.read_bundle(
            os.path.join(d, "give_up.supervisor.bundle.json"))
        attempts, restarts = trail(gtel)
        if rcs["give_up"] == 0 or len(attempts) != 2 or \
                bundle["tunnel"]["verdict"] != "OK":
            fail(f"supervise give-up: rc {rcs['give_up']}, attempts "
                 f"{attempts}, tunnel {bundle['tunnel']}")
        out["supervise"]["give_up"] = {
            "rc": rcs["give_up"], "attempts": attempts,
            "restarts": restarts, "tunnel": bundle["tunnel"]}
        out["supervise"]["seconds"] = round(time.perf_counter() - t0, 3)
        emit({"phase": "supervise_run", "card": smi, **out["supervise"]})
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    shutil.rmtree(d, ignore_errors=True)
    out["launches"] = claunch
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, PKG, "ops", "cuda", "csrc")):
        fail(f"run from a checkout: {PKG}/ops/cuda/csrc is not beside "
             "chip_smoke.py")
    sys.path.insert(0, HERE)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from mpi_cuda_process_tpu_torch import cli, driver, make_stencil
    from mpi_cuda_process_tpu_torch.interop import fields_from_numpy
    from mpi_cuda_process_tpu_torch.ops.stencil import k_step_margin
    from mpi_cuda_process_tpu_torch.ops.cuda import (_build, fullgrid, fused,
                                                     kernels, rawstep, remote,
                                                     streamfused)
    from mpi_cuda_process_tpu_torch.parallel import halo, mesh as mesh_lib
    from mpi_cuda_process_tpu_torch.parallel import stepper
    from mpi_cuda_process_tpu_torch.utils import checkpointing

    counters = (rawstep.launches, fused.launches, kernels.launches,
                fullgrid.launches, streamfused.launches, remote.launches)
    t_start = time.perf_counter()
    t_phase = [t_start]

    def took():
        """Seconds since the previous phase ended."""
        now = time.perf_counter()
        secs, t_phase[0] = round(now - t_phase[0], 3), now
        return secs
    dev = torch.device("cuda", torch.cuda.current_device())
    card_kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    # the card's peaks from the cost model's table (obs/costmodel.py), the
    # one source of the kernel table's bound_ms and the costmodel event
    from mpi_cuda_process_tpu_torch.obs import costmodel as costmodel_lib

    rates = costmodel_lib.card_rates(smi)
    bw, flops32 = rates["hbm"], rates["f32"]
    emit({"phase": "device", "ok": True, "kind": card_kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln]
             for n, log in _build.build_log.items()}
    took()
    emit({"phase": "build", "ok": True,
          "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": round(_build.build_seconds, 3), "ptxas": ptxas})

    # ---- 3. kernels against their plain versions ---------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(20261016)
    errs = {}  # kernel entry -> max |kernel - plain| over every comparison

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    def frame_of(shape, halo_w):
        return driver.frame_mask(shape, shape, (0, 0, 0), halo_w, dev)

    bit_views = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
                 torch.int32: torch.int32}

    def compare(entry, got, ref, atol, frame, rtol=0.0):
        worst = 0.0
        for g, r in zip(got, ref):
            if atol == rtol == 0.0 and g.dtype == r.dtype and \
                    g.shape == r.shape and torch.equal(
                        g.view(bit_views[g.dtype]), r.view(bit_views[r.dtype])):
                continue  # bit for bit, non-finite cells included
            g, r = g.float(), r.float()  # bfloat16: the difference exact
            d = (g - r).abs()
            err = float(d.max())
            bad = float((d - atol - rtol * r.abs()).max())
            if not math.isfinite(err) or bad > 0:
                first = torch.nonzero(~(d <= atol + rtol * r.abs()))[0]
                fail(f"{entry}: max|d| {err:.3e} > atol {atol:.3e} "
                     f"rtol {rtol:.1e}; shape {tuple(g.shape)}, "
                     f"non-finite: kernel {int((~torch.isfinite(g)).sum())}"
                     f" plain {int((~torch.isfinite(r)).sum())}, first bad "
                     f"cell {first.tolist()}: {float(g[tuple(first)])} "
                     f"against {float(r[tuple(first)])}")
            if frame is not None and not torch.equal(g[frame], r[frame]):
                fail(f"{entry}: frame cells differ")
            worst = max(worst, err)
        errs[entry] = max(errs.get(entry, 0.0), worst)
        return worst

    def virtual_mesh(shape):
        return mesh_lib.make_mesh(shape, [dev] * 4)

    def ring_of(mesh, axis):
        """(nxt, prv): each shard's next and previous neighbour along a
        mesh axis, as positions in the shard list."""
        n = mesh.shape[axis]

        def shifted(c, step):
            c = list(c)
            c[axis] = (c[axis] + step) % n
            return mesh.index(c)

        coords = list(mesh.coords())
        return ([shifted(c, 1) for c in coords],
                [shifted(c, -1) for c in coords])

    def case_stencil(label, dtype=None):
        """The stencil of a case label: a registry name, or advection with
        Courant numbers of both signs ("advect3d-mixed", "advect2d-mixed");
        in ``dtype`` where given."""
        kw = {"dtype": dtype} if dtype else {}
        if label == "advect3d-mixed":
            return make_stencil("advect3d", cx=-0.3, cy=0.2, cz=-0.25, **kw)
        if label == "advect2d-mixed":
            return make_stencil("advect2d", cx=-0.4, cy=0.2, **kw)
        return make_stencil(label, **kw)

    cases = []
    for shape in ((128, 128, 256), (66, 70, 130)):
        for name in ("heat3d", "heat3d27", "heat3d4th", "wave3d"):
            cases.append(("raw", name, shape, 1, False, None))
            cases.append(("zchunk", name, shape, 1, False, None))
        for name, k in (("heat3d", 4), ("heat3d27", 4), ("heat3d4th", 2),
                        ("heat3d4th", 4), ("wave3d", 4)):
            for periodic in (False, True):
                cases.append(("fused", name, shape, k, periodic, None))
    for name, k in (("heat3d", 4), ("heat3d27", 4), ("heat3d4th", 2),
                    ("wave3d", 4)):
        cases += [("raw", name, MAIN, 1, False, None),
                  ("zchunk", name, MAIN, 1, False, None),
                  ("fused", name, MAIN, k, False, None)]
        for shape in ((128, 128, 256), (68, 70, 130)):
            for periodic in (False, True):
                cases += [("sharded", name, shape, k, periodic, (2, 2)),
                          ("sharded", name, shape, k, periodic, (4, 1)),
                          ("zslab", name, shape, k, periodic, (4,))]
        for periodic in (False, True):
            for shape in ((128, 128, 256), (68, 76, 130)):
                cases += [("yzslab", name, shape, k, periodic, (2, 2)),
                          ("yzslab", name, shape, k, periodic, (1, 4))]
            shape = (128, 128, 256)
            cases += [("shell", name, shape, k, periodic, (2, 2)),
                      ("overlap_padded", name, shape, k, periodic, (2, 2)),
                      ("overlap_zslab", name, shape, k, periodic, (4,)),
                      ("overlap_yzslab", name, shape, k, periodic, (2, 2))]
        # K10 (guard-frame only): the whole grid at k = 1, 2, 4 and at the
        # main path's k at 512^3; the slab kernels on one shard's random
        # pieces; the stream kind's sharded steps, with the overlap shells
        for shape in ((128, 128, 256), (68, 76, 130)):
            cases += [("stream", name, shape, kk, False, None)
                      for kk in (1, 2, 4)]
            cases += [("stream_zslab", name, shape, k, False, (4,)),
                      ("stream_yzslab", name, shape, k, False, (2, 2)),
                      ("stream_yzslab", name, shape, k, False, (1, 4)),
                      ("stream_z", name, shape, k, False, (4,)),
                      ("stream_yz", name, shape, k, False, (2, 2)),
                      ("stream_yz", name, shape, k, False, (1, 4))]
        cases += [("stream", name, MAIN, k, False, None),
                  ("overlap_stream_z", name, (128, 128, 256), k, False,
                   (4,)),
                  ("overlap_stream_yz", name, (128, 128, 256), k, False,
                   (2, 2))]
    # advection (both Courant signs) and Gray-Scott: K1's advection kind and
    # the Gray-Scott raw step, K3 for k = 1, 2, 4 (the wrapper takes any k
    # whose window fits), K3's sharded mode and its overlap shells
    for label in ("advect3d", "advect3d-mixed", "grayscott3d"):
        for shape in ((128, 128, 256), (66, 70, 130)):
            cases.append(("raw", label, shape, 1, False, None))
            cases += [("fused", label, shape, kk, periodic, None)
                      for kk in (1, 2, 4) for periodic in (False, True)]
        cases += [("raw", label, MAIN, 1, False, None),
                  ("fused", label, MAIN, 4, False, None)]
        for shape in ((128, 128, 256), (68, 70, 130)):
            for periodic in (False, True):
                cases += [("sharded", label, shape, 4, periodic, (2, 2)),
                          ("sharded", label, shape, 4, periodic, (4, 1))]
        for periodic in (False, True):
            cases += [("shell", label, (128, 128, 256), 4, periodic, (2, 2)),
                      ("overlap_padded", label, (128, 128, 256), 4, periodic,
                       (2, 2))]
        # their pad-free kinds, K6 and K9 (four buffers for Gray-Scott,
        # both fields' slabs and corners), with and without the shells
        for periodic in (False, True):
            for shape in ((128, 128, 256), (68, 76, 130)):
                cases += [("zslab", label, shape, 4, periodic, (4,)),
                          ("yzslab", label, shape, 4, periodic, (2, 2)),
                          ("yzslab", label, shape, 4, periodic, (1, 4))]
            cases += [("overlap_zslab", label, (128, 128, 256), 4, periodic,
                       (4,)),
                      ("overlap_yzslab", label, (128, 128, 256), 4, periodic,
                       (2, 2))]
    # K10's advection and Gray-Scott kinds (every level keeps rings for u
    # and v): the whole grid, one shard's random pieces (z-only mesh of 4,
    # 2x2, 1x4) for k = 1..4 and at the main path's 512^3, bit for bit; the
    # stream kind's sharded steps against k plain sharded steps
    for label in ("advect3d", "advect3d-mixed", "grayscott3d"):
        for shape in ((128, 128, 256), (68, 76, 130)):
            for kk in (1, 2, 3, 4):
                cases += [("stream", label, shape, kk, False, None),
                          ("stream_zslab", label, shape, kk, False, (4,)),
                          ("stream_yzslab", label, shape, kk, False, (2, 2)),
                          ("stream_yzslab", label, shape, kk, False, (1, 4))]
            cases += [("stream_z", label, shape, 4, False, (4,)),
                      ("stream_yz", label, shape, 4, False, (2, 2))]
        cases += [("stream", label, MAIN, 4, False, None),
                  ("overlap_stream_yz", label, (128, 128, 256), 4, False,
                   (2, 2))]
    # --exchange rdma: the stream kind's sharded step through the ring
    # kernel against the same step with in-process copies, bit for bit,
    # two calls, on z-only, 2x2 and 1x4 meshes, with and without the shells
    for name, k in (("heat3d", 4), ("wave3d", 4), ("advect3d", 4),
                    ("grayscott3d", 4), ("sor3d", 2)):
        for mshape in ((4,), (2, 2), (1, 4)):
            cases += [(p, name, (128, 128, 256), k, False, mshape)
                      for p in ("rdma", "overlap_rdma")]
    # red-black SOR: every entry point of its kind, bit-equal (atol 0): K3
    # for k = 1..4 (both parities of k) and at 512^3, K3's sharded mode on
    # 2x2 and 4x1 meshes, K6, K9 on 2x2 and 1x4, the overlap shells and the
    # overlapped padded, z-slab and 2-axis steps, K10 for k = 1, 2, 4 and
    # at 512^3, its slab kernels on random pieces and its sharded steps;
    # guard frame and (even extents) periodic.  (72, 72, 130): even shard
    # extents on every mesh here, ragged in x.
    for shape in ((128, 128, 256), (66, 70, 130)):
        cases += [("fused", "sor3d", shape, kk, periodic, None)
                  for kk in (1, 2, 3, 4) for periodic in (False, True)]
        cases += [("stream", "sor3d", shape, kk, False, None)
                  for kk in (1, 2, 4)]
    cases += [("fused", "sor3d", MAIN, 4, False, None),
              ("stream", "sor3d", MAIN, 4, False, None)]
    for shape in ((128, 128, 256), (72, 72, 130)):
        for periodic in (False, True):
            cases += [("sharded", "sor3d", shape, 4, periodic, (2, 2)),
                      ("sharded", "sor3d", shape, 2, periodic, (4, 1)),
                      ("zslab", "sor3d", shape, 4, periodic, (4,)),
                      ("yzslab", "sor3d", shape, 4, periodic, (2, 2)),
                      ("yzslab", "sor3d", shape, 2, periodic, (1, 4))]
        cases += [("stream_zslab", "sor3d", shape, 4, False, (4,)),
                  ("stream_yzslab", "sor3d", shape, 4, False, (2, 2)),
                  ("stream_yzslab", "sor3d", shape, 2, False, (1, 4)),
                  ("stream_z", "sor3d", shape, 4, False, (4,)),
                  ("stream_yz", "sor3d", shape, 4, False, (2, 2)),
                  ("stream_yz", "sor3d", shape, 2, False, (1, 4))]
    for periodic in (False, True):
        shape = (128, 128, 256)
        cases += [("shell", "sor3d", shape, 4, periodic, (2, 2)),
                  ("overlap_padded", "sor3d", shape, 4, periodic, (2, 2)),
                  ("overlap_zslab", "sor3d", shape, 4, periodic, (4,)),
                  ("overlap_yzslab", "sor3d", shape, 4, periodic, (2, 2))]
    cases += [("overlap_stream_z", "sor3d", (128, 128, 256), 4, False,
               (4,)),
              ("overlap_stream_yz", "sor3d", (128, 128, 256), 4, False,
               (2, 2))]
    checked = []
    for path, label, shape, k, periodic, mshape in cases:
        st = case_stencil(label)
        name = st.name
        rtol = 0.0
        frame = None if periodic else frame_of(shape, st.halo)
        if path == "zchunk":
            h = st.halo
            p = rand(tuple(s + 2 * h for s in shape))
            ins = (p,) + ((rand(shape),) if st.num_fields == 2 else ())
            ref = st.update(ins)[:1]
            got = kernels.make_pallas_compute(st, device=dev)(ins)[:1]
            entry = ("zchunk_wave" if name == "wave3d"
                     else f"zchunk_heat<{name}>")
            # K4 and K5 (march.cuh) bit for bit
            atol = 0.0
            frame = None
            if name == "wave3d" and kernels.make_pallas_compute(st)(
                    ins)[1] is not ins[1]:
                fail("zchunk_wave: the second output is not u_prev")
        elif path == "shell":
            # the hi shells of shard (1, 1) of a 2x2 mesh, on random strips
            m = k_step_margin(st, k)
            local = (shape[0] // 2, shape[1] // 2, shape[2])
            shells = fused.build_overlap_shell_calls(
                st, local, shape, k, (0, 1), periodic=periodic, device=dev)
            got, ref = [], []
            for d in (0, 1):
                pshape = [local[0] + 2 * m, local[1] + 2 * m, local[2]]
                pshape[d] = 4 * m
                strips = tuple(rand(tuple(pshape))
                               for _ in range(st.num_fields))
                org = [local[0], local[1]]
                org[d] += local[d] - 2 * m
                got += shells[d](*strips) if periodic else \
                    shells[d](tuple(org), *strips)
                ref += fused.plain_step_padded(strips, st, k, shape, org,
                                               periodic)
            entry = f"fused_shell<{name}>"
            atol = 1e-4
            frame = None
        elif path in ("stream_zslab", "stream_yzslab"):
            # one shard's core and random slabs (and corners): the second
            # shard of a z-only mesh of 4, shard (1, 0) of a 2x2 mesh, the
            # second of a 1x4 mesh; bit for bit against the plain version
            m = k_step_margin(st, k)
            Z, Y, X = shape

            def per_field(s):
                return tuple(rand(s) for _ in range(st.num_fields))

            if path == "stream_zslab":
                Lz = Z // 4
                core, lo, hi = (per_field((Lz, Y, X)), per_field((m, Y, X)),
                                per_field((m, Y, X)))
                got = streamfused.stream_zslab(core, lo, hi, st, k, Z, Lz)
                ref = fused.plain_zslab(core, lo, hi, st, k, Z, Lz)
            else:
                Lz, Ly = Z // mshape[0], Y // mshape[1]
                org = (Lz, 0) if mshape[0] > 1 else (0, Ly)
                core = per_field((Lz, Ly, X))
                zlo, zhi = per_field((m, Ly, X)), per_field((m, Ly, X))
                ylo, yhi = per_field((Lz, m, X)), per_field((Lz, m, X))
                corners = [per_field((m, m, X)) for _ in range(4)]
                args = (core, zlo, zhi, ylo, yhi, corners, st, k, shape, org)
                got = streamfused.stream_yzslab(*args)
                ref = fused.plain_yzslab(*args)
                del zlo, zhi, ylo, yhi, corners, args
            del core
            entry = f"{path}<{name}>"
            atol = 0.0
            frame = None
        elif path in ("rdma", "overlap_rdma"):
            mesh = virtual_mesh(mshape)
            fields = stepper.shard_fields(
                tuple(rand(shape) for _ in range(st.num_fields)), mesh, 3)
            overlap = path == "overlap_rdma"
            outs = []
            for exchange in ("ppermute", "rdma"):
                step = stepper.make_sharded_fused_step(
                    st, mesh, shape, k, kind="stream", overlap=overlap,
                    exchange=exchange, device=dev)
                if step._overlap_active != overlap:
                    fail(f"{path} {name}: overlap split not taken")
                remote.launches.clear()
                outs.append(stepper.gather_fields(step(step(fields))))
                if (exchange == "rdma") != bool(remote.launches):
                    fail(f"{path} {name} {exchange}: ring launches "
                         f"{dict(remote.launches)}")
            ref, got = outs
            if step._rdma_backend != "cuda-ring":
                fail(f"{path} {name}: backend {step._rdma_backend}")
            entry = f"rdma_step<{name}>"
            atol = 0.0
            frame = None
            del fields, outs
        elif path in ("sharded", "zslab", "yzslab") or \
                path.startswith(("overlap", "stream_")):
            mesh = virtual_mesh(mshape)
            fields = stepper.shard_fields(
                tuple(rand(shape) for _ in range(st.num_fields)), mesh, 3)
            plain = stepper.make_sharded_step(st, mesh, shape,
                                              periodic=periodic)
            ref = fields
            for _ in range(k):
                ref = plain(ref)
            overlap = path.startswith("overlap")
            fuse_kind = (None if path in ("sharded", "overlap_padded") else
                         "stream" if "stream" in path else "padfree")
            step = stepper.make_sharded_fused_step(
                st, mesh, shape, k, periodic=periodic, kind=fuse_kind,
                overlap=overlap, device=dev)
            if step._overlap_active != overlap:
                fail(f"{path} {name}: overlap split not taken")
            got = stepper.gather_fields(step(fields))
            ref = stepper.gather_fields(ref)
            entry = {"sharded": f"fused_step_padded<{name}>",
                     "zslab": f"fused_zslab<{name}>",
                     "yzslab": f"fused_yzslab<{name}>"}.get(
                         path, f"{path}<{name}>")
            atol = 1e-4
            del fields
        else:
            fields = tuple(rand(shape) for _ in range(st.num_fields))
            ref = fused.plain_steps(fields, st, k, periodic)
            if path == "raw":
                got = rawstep.make_raw_step(st, shape, device=dev)(fields)
                entry = {"wave3d": "raw_step_wave",
                         "grayscott3d": "raw_step_grayscott"}.get(
                             name, f"raw_step_heat<{name}>")
                atol = 0.0  # K1, K2, Gray-Scott (march.cuh): bit for bit
                if name == "wave3d" and got[1] is not fields[0]:
                    fail("raw_step_wave: the new u_prev is not the old u")
            elif path == "stream":
                got = streamfused.make_stream_fused_step(st, shape, k,
                                                         device=dev)(fields)
                entry = f"stream_step<{name}>"
                atol = 0.0
            else:
                got = fused.fused_step(fields, st, k, periodic=periodic)
                entry = f"fused_step<{name}>"
                atol = 1e-4
            del fields
        if name in SOR or (name in ("advect3d", "grayscott3d") and path in (
                "zslab", "yzslab", "overlap_zslab", "overlap_yzslab")):
            atol = 0.0  # SOR and the new pad-free kinds: bit for bit
        torch.cuda.synchronize()
        err = compare(entry, got, ref, atol, frame, rtol)
        checked.append({"kernel": entry, "label": label,
                        "shape": list(shape), "k": k,
                        "periodic": periodic, "mesh": mshape,
                        "max_abs_err": err, "atol": atol, "rtol": rtol})
        del ref, got
    # 2D: K7 whole2d and K8 fullgrid (RAW; PADDED through the row-split
    # stepper, with the overlap shells for even k)
    def rand2d(name, shape):
        if name == "life":
            return ((rand(shape) < 0.35).to(torch.int32),)
        return tuple(rand(shape) for _ in range(case_stencil(name).num_fields))

    cases2d = []
    for shape in ((128, 256), (130, 258), (1000, 777), GRID2D):
        big = shape == GRID2D
        for name in ("life", "heat2d"):
            cases2d.append(("whole2d", name, shape, 1, False))
        for name in ("life", "heat2d", "wave2d"):
            for k in ((FUSE2D,) if big else (1, 2, 4, 8)):
                for periodic in ((False,) if big else (False, True)):
                    cases2d.append(("fullgrid_step", name, shape, k,
                                    periodic))
                    if not (big and name == "wave2d"):
                        cases2d.append(("fullgrid_padded", name, shape, k,
                                        periodic))
    # K8 for advect2d (both Courant signs) and grayscott2d (four buffers)
    for shape in ((128, 256), (130, 258), GRID2D):
        big = shape == GRID2D
        for label in ("advect2d", "advect2d-mixed", "grayscott2d"):
            if big and label == "advect2d":
                continue
            for k in ((FUSE2D,) if big else (1, 2, 4, 8)):
                for periodic in ((False,) if big else (False, True)):
                    cases2d.append(("fullgrid_step", label, shape, k,
                                    periodic))
                    if not big or label == "grayscott2d":
                        cases2d.append(("fullgrid_padded", label, shape, k,
                                        periodic))
    # K8 for sor2d (margin 2k), bit-equal: shapes whose --mesh 4 shards
    # have even rows (200: 50 >= 3m at k = 8, so the shells run there too)
    for shape in ((128, 256), (200, 258), (1000, 777), GRID2D):
        big = shape == GRID2D
        for k in ((FUSE2D,) if big else (1, 2, 3, 4, 8)):
            for periodic in ((False, True) if shape[1] % 2 == 0 and not big
                             else (False,)):
                cases2d += [("fullgrid_step", "sor2d", shape, k, periodic),
                            ("fullgrid_padded", "sor2d", shape, k,
                             periodic)]
    for path, label, shape, k, periodic in cases2d:
        st = case_stencil(label)
        name = st.name
        exact = name == "life"
        frame = None if periodic else driver.frame_mask(shape, shape, (0, 0),
                                                        1, dev)
        mshape = None
        rtol = 0.0
        if path == "whole2d":
            ins = rand2d(name, tuple(s + 2 for s in shape))
            ref = st.update(ins)
            got = kernels.make_pallas_compute(st, device=dev)(ins)
            atol = rtol = 0.0  # K7 (redesigned): bit for bit
            frame = None
        elif path == "fullgrid_step":
            fields = rand2d(name, shape)
            plain = driver.make_step(st, shape, periodic=periodic)
            ref = fields
            for _ in range(k):
                ref = plain(ref)
            got = fullgrid.make_fullgrid_step(st, shape, k, periodic=periodic,
                                              device=dev)(fields)
            atol = 0.0 if exact else 1e-4
            del fields
        else:
            n = 2 if shape[0] % 4 else 4
            mshape = (n,)
            mesh = virtual_mesh(mshape)
            fields = stepper.shard_fields(rand2d(name, shape), mesh, 2)
            plain = stepper.make_sharded_step(st, mesh, shape,
                                              periodic=periodic)
            ref = fields
            for _ in range(k):
                ref = plain(ref)
            # the shells run for even k where the rows host them (3m)
            split = shape[0] // n >= 3 * k_step_margin(st, k)
            step = stepper.make_sharded_temporal_step(
                st, mesh, shape, k, periodic=periodic, overlap=k % 2 == 0,
                device=dev)
            if step._overlap_active != (k % 2 == 0 and split):
                fail(f"fullgrid_padded {name} k={k}: overlap split not taken")
            got = stepper.gather_fields(step(fields))
            ref = stepper.gather_fields(ref)
            atol = 0.0 if exact else 1e-4
            del fields
        entry = f"{path}<{name}>"
        if name in SOR:
            atol = 0.0  # the SOR kinds are held bit for bit
        torch.cuda.synchronize()
        err = compare(entry, got, ref, atol, frame, rtol)
        checked.append({"kernel": entry, "shape": list(shape), "k": k,
                        "periodic": periodic, "mesh": mshape,
                        "max_abs_err": err, "atol": atol, "rtol": rtol})
        del ref, got
    # the ring exchange (row 19): every ring of one mesh axis on the card in
    # one launch, each chunk landed in place, against plain_ring_exchange
    # (the protocol walked in order on the same tensors) bit for bit, three
    # launches back to back, every chunk's ready counter read after each
    # (drained: the blocks that wrote the chunk).  Sites: the sharded main
    # path's z slab, y slab and corner of a 2x2 shard of 1024^3 and the z slab of a
    # --mesh 4 shard, a 1x4 mesh's y slab, and small slabs that pick_chunks
    # cuts into (0, 4) and (0, 1) chunks, on every ring of z (4), y (1, 4)
    # and (2, 2) meshes; ring depths 2, 3, 4 and a preferred chunk count 8
    sites = [((2, 2), 0, (4, 512, 1024)), ((2, 2), 1, (512, 4, 1024)),
             ((2, 2), 1, (4, 4, 1024)), ((4,), 0, (4, 1024, 1024)),
             ((1, 4), 1, (512, 4, 1024))]
    sites += [(mshape, axis, shape)
              for mshape, axis in (((4,), 0), ((1, 4), 1), ((2, 2), 0),
                                   ((2, 2), 1))
              for shape in ((24, 4, 128), (3, 5, 130))]
    for mshape, axis, shape in sites:
        mesh = virtual_mesh(mshape)
        nxt, prv = ring_of(mesh, axis)
        hi = [rand(shape) for _ in range(4)]
        lo = [rand(shape) for _ in range(4)]
        entry = f"ring_exchange<{'x'.join(map(str, shape))}>"
        for nslots, prefer_nc in ((2, 0), (3, 0), (4, 0), (2, 8)):
            call, meta = remote.build_ring_exchange_call(
                shape, torch.float32, nslots=nslots, prefer_nc=prefer_nc,
                device=dev)
            ref = remote.plain_ring_exchange(
                hi, lo, nxt, prv, meta,
                remote.RingState(meta, 4, dev))
            for _ in range(3):
                remote.launches.clear()
                got = call(hi, lo, nxt, prv)
                torch.cuda.synchronize()
                if sum(remote.launches.values()) != 1:
                    fail(f"{entry}: launches {dict(remote.launches)}")
                call.state.check_drained(meta)
                err = compare(entry, got[0] + got[1], ref[0] + ref[1], 0.0,
                              None)
            checked.append({"kernel": entry, "shape": list(shape),
                            "mesh": mshape, "axis": axis, "nslots": nslots,
                            "prefer_nc": prefer_nc,
                            "chunks": [meta["chunk_axis"], meta["nchunks"]],
                            "blocks": call.state.blocks, "launches": 3,
                            "drained": True, "max_abs_err": err,
                            "atol": 0.0})
            del ref, got, call
        del hi, lo
    peer_ring_checks(dev, rand, compare, checked, virtual_mesh, ring_of)
    # bfloat16 kinds, bit for bit against their plain versions on bfloat16
    # tensors: K1 (four tap sets, advection with both Courant signs), K2 and
    # raw_step_grayscott at a ragged shape and 512^3 (two steps); K10 RAW at
    # a ragged shape and 512^3, ZSLAB on one shard of 1024^3 --mesh 4 and
    # YZSLAB on one of 1024^3 --mesh 2,2 (random cores, slabs and corners),
    # every family; the ring exchange at the f32 sites, config 5's z-slab
    # site and a ragged (2-byte unit) one, its counters drained after every
    # launch
    bf16 = torch.bfloat16

    def rand16(shape):
        return rand(shape).to(bf16)

    bcases = []
    for label in ("heat3d", "heat3d27", "heat3d4th", "wave3d", "advect3d",
                  "advect3d-mixed", "grayscott3d"):
        bcases += [("raw", label, shape, 1)
                   for shape in ((66, 70, 130), MAIN)]
    for name, k in BF16_FAMILIES:
        bcases += [("stream", name, shape, k)
                   for shape in ((68, 76, 130), MAIN)]
        bcases += [("stream_zslab", name, BIG, k),
                   ("stream_yzslab", name, BIG, k)]
    bcases.append(("stream", "advect3d-mixed", MAIN, 4))
    for path, label, shape, k in bcases:
        st = case_stencil(label, BF16)
        name = st.name
        m = k_step_margin(st, k)
        nf = st.num_fields
        frame = None
        if path == "stream_zslab":
            Lz, Y, X = shape[0] // 4, shape[1], shape[2]
            core = tuple(rand16((Lz, Y, X)) for _ in range(nf))
            lo = tuple(rand16((m, Y, X)) for _ in range(nf))
            hi = tuple(rand16((m, Y, X)) for _ in range(nf))
            got = streamfused.stream_zslab(core, lo, hi, st, k, shape[0], Lz)
            ref = fused.plain_zslab(core, lo, hi, st, k, shape[0], Lz)
            del core, lo, hi
        elif path == "stream_yzslab":
            Lz, Ly, X = shape[0] // 2, shape[1] // 2, shape[2]
            yz_args = (tuple(rand16((Lz, Ly, X)) for _ in range(nf)),
                       *(tuple(rand16(s_) for _ in range(nf))
                         for s_ in ((m, Ly, X), (m, Ly, X), (Lz, m, X),
                                    (Lz, m, X))),
                       [tuple(rand16((m, m, X)) for _ in range(nf))
                        for _ in range(4)], st, k, shape, (Lz, 0))
            got = streamfused.stream_yzslab(*yz_args)
            ref = fused.plain_yzslab(*yz_args)
            del yz_args
        else:
            frame = frame_of(shape, st.halo)
            fields = tuple(rand16(shape) for _ in range(nf))
            if path == "raw":
                step = rawstep.make_raw_step(st, shape, device=dev)
                got = step(step(fields))
                ref = fused.plain_steps(fields, st, 2)
            else:
                got = streamfused.make_stream_fused_step(
                    st, shape, k, device=dev)(fields)
                ref = fused.plain_steps(fields, st, k)
            del fields
        torch.cuda.synchronize()
        wrapper = {"raw": raw_key(name).partition("[")[0]}.get(
            path, "stream_step" if path == "stream" else path)
        entry = f"{wrapper}<{name},{BF16}>"
        err = compare(entry, got, ref, 0.0, frame)
        checked.append({"kernel": entry, "label": label,
                        "shape": list(shape), "k": k, "dtype": BF16,
                        "max_abs_err": err, "atol": 0.0})
        del got, ref
    # K3 (RAW; PADDED on one shard's padded block), its overlap shells, K6
    # and K9 (one shard's random core, slabs and corners) in bfloat16,
    # every family at its BF16_FUSE k, guard frame and periodic, at
    # (66, 70, 130) (RAW) or a (128, 128, 256) grid's shards and at 512^3;
    # and K6 and K9 in float32 for advection (both Courant signs) and
    # Gray-Scott at k = 1..4: all bit for bit against the plain versions
    fcases = []
    for label in ("heat3d", "heat3d27", "heat3d4th", "wave3d", "advect3d",
                  "advect3d-mixed", "grayscott3d", "sor3d"):
        k = BF16_FUSE[label.partition("-")[0]]
        for periodic in (False, True):
            fcases.append(("fused_step", label, bf16, (66, 70, 130), k,
                           periodic))
            fcases += [(w, label, bf16, (128, 128, 256), k, periodic)
                       for w in ("fused_step_padded", "fused_shell",
                                 "fused_zslab", "fused_yzslab")]
        fcases += [(w, label, bf16, MAIN, k, False)
                   for w in ("fused_step", "fused_step_padded",
                             "fused_zslab", "fused_yzslab")]
    for label in ("advect3d", "advect3d-mixed", "grayscott3d"):
        for shape in ((128, 128, 256), (68, 76, 130)):
            fcases += [(w, label, torch.float32, shape, kk, periodic)
                       for w in ("fused_zslab", "fused_yzslab")
                       for kk in (1, 2, 3, 4) for periodic in (False, True)]
    for wrapper, label, dt, shape, k, periodic in fcases:
        st = case_stencil(label, BF16 if dt == bf16 else None)
        name, nf, m = st.name, st.num_fields, k_step_margin(st, k)
        Z, Y, X = shape
        Lz, Ly = Z // 2, Y // 2

        def pieces(s, dt=dt, nf=nf):
            return tuple(rand(s).to(dt) for _ in range(nf))

        frame = None
        if wrapper == "fused_step":
            fields = pieces(shape)
            got = fused.fused_step(fields, st, k, periodic=periodic)
            ref = fused.plain_steps(fields, st, k, periodic)
            frame = None if periodic else frame_of(shape, st.halo)
            del fields
        elif wrapper == "fused_step_padded":
            # shard (1, 0) of a 2x2 mesh: a wall on y, a neighbour on z
            padded = pieces((Lz + 2 * m, Ly + 2 * m, X))
            got = fused.fused_step_padded(padded, st, k, shape, (Lz, 0),
                                          periodic)
            ref = fused.plain_step_padded(padded, st, k, shape, (Lz, 0),
                                          periodic)
            del padded
        elif wrapper == "fused_shell":
            # the hi z and y shells of shard (1, 1) of a 2x2 mesh
            local = (Lz, Ly, X)
            shells = fused.build_overlap_shell_calls(
                st, local, shape, k, (0, 1), periodic=periodic, device=dev)
            got, ref = [], []
            for d in (0, 1):
                pshape = [Lz + 2 * m, Ly + 2 * m, X]
                pshape[d] = 4 * m
                strips = pieces(tuple(pshape))
                org = [Lz, Ly]
                org[d] += local[d] - 2 * m
                got += shells[d](*strips) if periodic else \
                    shells[d](tuple(org), *strips)
                ref += fused.plain_step_padded(strips, st, k, shape, org,
                                               periodic)
            del strips
        elif wrapper == "fused_zslab":
            # the second shard of a z-only mesh of 4
            core = pieces((Z // 4, Y, X))
            lo, hi = pieces((m, Y, X)), pieces((m, Y, X))
            args = (core, lo, hi, st, k, Z, Z // 4, periodic)
            got, ref = fused.fused_zslab(*args), fused.plain_zslab(*args)
            del core, lo, hi, args
        else:
            # shard (1, 0) of a 2x2 mesh
            args = (pieces((Lz, Ly, X)), pieces((m, Ly, X)),
                    pieces((m, Ly, X)), pieces((Lz, m, X)),
                    pieces((Lz, m, X)), [pieces((m, m, X)) for _ in range(4)],
                    st, k, shape, (Lz, 0), periodic)
            got, ref = fused.fused_yzslab(*args), fused.plain_yzslab(*args)
            del args
        torch.cuda.synchronize()
        tag = f"{name},{BF16}" if dt == bf16 else name
        entry = f"{wrapper}<{tag}>"
        err = compare(entry, got, ref, 0.0, frame)
        checked.append({"kernel": entry, "label": label,
                        "shape": list(shape), "k": k, "periodic": periodic,
                        "dtype": str(dt).replace("torch.", ""),
                        "max_abs_err": err, "atol": 0.0})
        del got, ref
    # K4 (three tap sets), K5, K7 and K8 (every float 2D family) in
    # bfloat16, bit for bit against their plain versions on bfloat16
    # tensors: K4/K5 on a ragged padded block and on one 1024^3 2x2 shard's;
    # K7 at a ragged shape and 16384^2; K8 RAW at k = 3 and 16 (sor2d 8),
    # guard-frame and periodic, at (130, 258) and guard-frame at 16384^2;
    # K8 PADDED through the --mesh 4 row-split stepper, with and without the
    # overlap shells, at (256, 258), and on one 16384^2 --mesh 4 shard's
    # padded block
    ccases = []
    for label in ("heat3d", "heat3d27", "heat3d4th", "wave3d"):
        ccases += [("compute", label, shape, 1, False)
                   for shape in ((66, 70, 130), (512, 512, 1024))]
    ccases += [("whole2d", "heat2d", shape, 1, False)
               for shape in ((130, 258), GRID2D)]
    for label in ("heat2d", "wave2d", "advect2d-mixed", "grayscott2d",
                  "sor2d"):
        k2 = BF16_FUSE2D[label.partition("-")[0]]
        ccases += [(path, label, shape, k, periodic)
                   for path, shape in (("fullgrid_step", (130, 258)),
                                       ("fullgrid_sharded", (256, 258)))
                   for k in (3, k2) for periodic in (False, True)]
        ccases += [("fullgrid_step", label, GRID2D, k2, False),
                   ("fullgrid_padded", label, GRID2D, k2, False)]
    for path, label, shape, k, periodic in ccases:
        st = case_stencil(label, BF16)
        name, nf = st.name, st.num_fields
        frame = None
        if path == "compute":
            h = st.halo
            ins = (rand16(tuple(s_ + 2 * h for s_ in shape)),) + (
                (rand16(shape),) if nf == 2 else ())
            got = kernels.make_pallas_compute(st, device=dev)(ins)[:1]
            ref = st.update(ins)[:1]
            entry = ("zchunk_wave" if name == "wave3d" else "zchunk_heat") \
                + f"<{name},{BF16}>"
            del ins
        elif path == "whole2d":
            ins = (rand16(tuple(s_ + 2 for s_ in shape)),)
            got = kernels.make_pallas_compute(st, device=dev)(ins)
            ref = st.update(ins)
            entry = f"whole2d<{name},{BF16}>"
            del ins
        elif path == "fullgrid_step":
            fields = tuple(rand16(shape) for _ in range(nf))
            plain = driver.make_step(st, shape, periodic=periodic)
            ref = fields
            for _ in range(k):
                ref = plain(ref)
            got = fullgrid.make_fullgrid_step(st, shape, k, periodic=periodic,
                                              device=dev)(fields)
            frame = None if periodic else driver.frame_mask(
                shape, shape, (0, 0), 1, dev)
            entry = f"fullgrid_step<{name},{BF16}>"
            del fields
        elif path == "fullgrid_padded":
            # the second shard of a --mesh 4 row split of the grid
            m = k_step_margin(st, k)
            Ly = shape[0] // 4
            ins = tuple(rand16((Ly + 2 * m, shape[1])) for _ in range(nf))
            got = fullgrid.fullgrid_padded(ins, st, k, shape[0], Ly)
            ref = tuple(r[m:m + Ly] for r in fused._plain_window_steps(
                ins, st, k, (Ly - m, 0), shape, False, wrap_axes=(1,)))
            entry = f"fullgrid_padded<{name},{BF16}>"
            del ins
        else:
            mesh = virtual_mesh((4,))
            fields = stepper.shard_fields(
                tuple(rand16(shape) for _ in range(nf)), mesh, 2)
            plain = stepper.make_sharded_step(st, mesh, shape,
                                              periodic=periodic)
            ref = fields
            for _ in range(k):
                ref = plain(ref)
            ref = stepper.gather_fields(ref)
            got = []
            for overlap in (False, True):
                step = stepper.make_sharded_temporal_step(
                    st, mesh, shape, k, periodic=periodic, overlap=overlap,
                    device=dev)
                if step._overlap_active != overlap:
                    fail(f"fullgrid_padded {name} bf16 k={k}: overlap split "
                         "not taken")
                got += stepper.gather_fields(step(fields))
            ref = ref + ref
            entry = f"fullgrid_padded<{name},{BF16}>"
            del fields
        torch.cuda.synchronize()
        err = compare(entry, got, ref, 0.0, frame)
        checked.append({"kernel": entry, "label": label, "path": path,
                        "shape": list(shape), "k": k, "periodic": periodic,
                        "dtype": BF16, "max_abs_err": err, "atol": 0.0})
        del got, ref
    for mshape, axis, shape in sites + [((4,), 0, (4, 4096, 4096)),
                                        ((4,), 0, (4, 7, 129))]:
        mesh = virtual_mesh(mshape)
        nxt, prv = ring_of(mesh, axis)
        hi = [rand16(shape) for _ in range(4)]
        lo = [rand16(shape) for _ in range(4)]
        entry = f"ring_exchange<{'x'.join(map(str, shape))},{BF16}>"
        for nslots, prefer_nc in ((2, 0), (3, 0), (2, 8)):
            call, meta = remote.build_ring_exchange_call(
                shape, bf16, nslots=nslots, prefer_nc=prefer_nc, device=dev)
            ref = remote.plain_ring_exchange(
                hi, lo, nxt, prv, meta, remote.RingState(meta, 4, dev))
            for _ in range(3):
                remote.launches.clear()
                got = call(hi, lo, nxt, prv)
                torch.cuda.synchronize()
                if sum(remote.launches.values()) != 1:
                    fail(f"{entry}: launches {dict(remote.launches)}")
                call.state.check_drained(meta)
                err = compare(entry, got[0] + got[1], ref[0] + ref[1], 0.0,
                              None)
            checked.append({"kernel": entry, "shape": list(shape),
                            "mesh": mshape, "axis": axis, "nslots": nslots,
                            "prefer_nc": prefer_nc, "dtype": BF16,
                            "chunks": [meta["chunk_axis"], meta["nchunks"]],
                            "blocks": call.state.blocks, "launches": 3,
                            "drained": True, "max_abs_err": err,
                            "atol": 0.0})
            del ref, got, call
        del hi, lo
    # K10 and K8's streaming kind, redesigned (csrc/ring.cuh): every
    # streamfused.TILES and fullgrid.RING_TILES entry at its table tile with
    # the fast paths and on the per-cell path (PATHS = 0, the switch the
    # tests use), K10 as RAW, ZSLAB and YZSLAB and K8 as RAW and PADDED,
    # bit for bit
    def both_paths(module, fn):
        saved = module.PATHS
        outs = [fn()]
        module.PATHS = 0
        try:
            outs.append(fn())
        finally:
            module.PATHS = saved
        return outs

    Z3, Y3, X3 = RING3D
    for (name, dname, k), tile in sorted(streamfused.TILES.items()):
        label = "advect3d-mixed" if name == "advect3d" else name
        st = case_stencil(label, getattr(torch, dname))
        nf, m = st.num_fields, k_step_margin(st, k)

        def pieces(shape):
            return tuple(rand(shape).to(st.dtype) for _ in range(nf))

        core = pieces(RING3D)
        zlo, zhi = pieces((m, Y3, X3)), pieces((m, Y3, X3))
        ylo, yhi = pieces((Z3, m, X3)), pieces((Z3, m, X3))
        corners = [pieces((m, m, X3)) for _ in range(4)]
        gshape = (3 * Z3, 3 * Y3, X3)
        zs = (core, zlo, zhi, st, k, 3 * Z3, Z3)
        yz = (core, zlo, zhi, ylo, yhi, corners, st, k, gshape, (Z3, Y3))
        for wrapper, fn, ref, frame in (
                ("stream_step", lambda: streamfused.stream_step(core, st, k),
                 fused.plain_steps(core, st, k), frame_of(RING3D, st.halo)),
                ("stream_zslab", lambda: streamfused.stream_zslab(*zs),
                 fused.plain_zslab(*zs), None),
                ("stream_yzslab", lambda: streamfused.stream_yzslab(*yz),
                 fused.plain_yzslab(*yz), None)):
            for path, got in zip(("fast", "per-cell"),
                                 both_paths(streamfused, fn)):
                torch.cuda.synchronize()
                entry = f"{wrapper}<{name},{dname},k={k},{path}>"
                err = compare(entry, got, ref, 0.0, frame)
                checked.append({"kernel": entry, "shape": list(RING3D),
                                "tile": list(tile), "max_abs_err": err,
                                "atol": 0.0})
            del ref
        del core, zlo, zhi, ylo, yhi, corners, zs, yz
    H2, W2 = RING2D
    for (name, dname, k), tile in sorted(fullgrid.RING_TILES.items()):
        label = "advect2d-mixed" if name == "advect2d" else name
        st = case_stencil(label, getattr(torch, dname))
        m = k_step_margin(st, k)
        for mode, rows in (("raw", H2), ("padded", H2 + 2 * m)):
            if name == "life":
                fields = ((rand((rows, W2)) < 0.35).to(torch.int32),)
            else:
                fields = tuple(rand((rows, W2)).to(st.dtype)
                               for _ in range(st.num_fields))
            if mode == "raw":
                ref = fused.plain_steps(fields, st, k)
                def fn():
                    return fullgrid.fullgrid_step(fields, st, k)
                frame = frame_of(RING2D, st.halo)
            else:
                out = fused._plain_window_steps(
                    fields, st, k, (H2 - m, 0), (3 * H2, W2), False,
                    wrap_axes=(1,))
                ref = tuple(f[m:m + H2] for f in out)
                def fn():
                    return fullgrid.fullgrid_padded(fields, st, k, 3 * H2,
                                                    H2)
                frame = None
            wrapper = "fullgrid_step" if mode == "raw" else \
                "fullgrid_padded"
            for path, got in zip(("fast", "per-cell"),
                                 both_paths(fullgrid, fn)):
                torch.cuda.synchronize()
                entry = f"{wrapper}<{name},{dname},k={k},{path}>"
                err = compare(entry, got, ref, 0.0, frame)
                checked.append({"kernel": entry, "shape": [H2, W2],
                                "tile": list(tile), "max_abs_err": err,
                                "atol": 0.0})
            del fields, ref
    # K1, K2, Gray-Scott's raw step, K4, K5 and K7, redesigned
    # (csrc/march.cuh): every kernels.TILES and rawstep.TILES kind at its
    # table tile (bfloat16: cells in pairs), bit for bit against the plain
    # update (the raw kinds: two plain steps, every field, frame cells
    # equal), on blocks whose x extent falls in each residue mod 8, one
    # plane, one row, one cell (the raw kinds: the smallest grid they
    # take, and grids whose every tile touches a wall beside ones with
    # interior tiles), narrow ones, a run that does not divide the march
    # extent and, in bfloat16, inputs with subnormals, signed zeros and
    # sums on bfloat16 ties
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from compute_schedule import special_bf16

    march_kinds = [("compute", kv) for kv in sorted(kernels.TILES.items())]
    march_kinds += [("raw", kv) for kv in sorted(rawstep.TILES.items())]
    for path, ((name, dname), tile) in march_kinds:
        st = case_stencil("advect3d-mixed" if name == "advect3d" else name,
                          None if name == "life" else getattr(torch, dname))
        run, h = tile.zrun, st.halo
        if path == "raw":
            m = 2 * h + 1
            shapes = [(m + 4, m + 5, 64 + r) for r in range(8)] + [
                (m, m, m), (m, 9, 37), (9, m, 130), (run + 3, m + 2, 33),
                (m + 2, 40, 300), (40, 40, 600), (70, 37, 1100)]
        elif st.ndim == 3:
            shapes = [(5, 6, 64 + r) for r in range(8)] + [
                (1, 9, 37), (7, 1, 130), (9, 5, 1), (3, 2, 7),
                (run + 3, 3, 33), (2, 40, 300)]
        else:
            shapes = [(7, 512 + r) for r in range(8)] + [
                (1, 1000), (600, 1), (5, 3), (run + 3, 129), (2, 9000)]
        wrapper = raw_key(name).partition("[")[0] if path == "raw" else \
            "whole2d" if st.ndim == 2 else \
            "zchunk_wave" if name == "wave3d" else "zchunk_heat"
        for shape in shapes:
            first = shape if path == "raw" else \
                tuple(s_ + 2 * h for s_ in shape)
            shapes_in = (first,) + (shape,) * (st.num_fields - 1)
            for special in ((False, True) if dname == BF16 else (False,)):
                if name == "life":
                    ins = ((rand(first) < 0.35).to(torch.int32),)
                elif special:
                    ins = tuple(special_bf16(s_, gen, dev)
                                for s_ in shapes_in)
                else:
                    ins = tuple(rand(s_).to(st.dtype) for s_ in shapes_in)
                if path == "raw":  # two steps: K2's second reads the
                    # first's u as its u_prev
                    step = rawstep.make_raw_step(st, shape, device=dev)
                    plain = driver.make_step(st, shape)
                    got, ref = step(step(ins)), plain(plain(ins))
                    frame = frame_of(shape, h)
                else:
                    got = kernels.make_pallas_compute(st, device=dev)(
                        ins)[:1]
                    ref = st.update(ins)[:1]
                    frame = None
                torch.cuda.synchronize()
                entry = f"{wrapper}<{name},{dname}>"
                err = compare(entry, got, ref, 0.0, frame)
                checked.append({"kernel": entry, "shape": list(shape),
                                "tile": list(tile), "special": special,
                                "max_abs_err": err, "atol": 0.0})
    for c in counters:
        c.clear()
    emit({"phase": "kernels", "ok": True, "seconds": took(),
          "checked": len(checked), "max_abs_err": errs, "cases": checked})
    torch.cuda.empty_cache()

    # ---- 4. unsharded main path through cli.main() -------------------------
    scratch = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    lines = []
    main_launches = {}  # counter key -> launches over every main-path run

    class Capture(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logging.getLogger(PKG).addHandler(Capture())
    runs = {}

    def counted(fn):
        """Run ``fn`` with every launch counter set to 0 just before and
        read just after; returns (result, launches of this run)."""
        for c in counters:
            c.clear()
        out = fn()
        got = {}
        for c in counters:
            got.update(c)
        for key, n in got.items():
            main_launches[key] = main_launches.get(key, 0) + n
        return out, got

    def drive(label, stencil, *flags, iters=ITERS, ckpt_every=ITERS,
              grid=MAIN):
        d = os.path.join(scratch, label)
        lines.clear()
        rc, got = counted(lambda: cli.main(
            ["--stencil", stencil, "--grid", ",".join(map(str, grid)),
             "--iters", str(iters), "--checkpoint-every", str(ckpt_every),
             "--checkpoint-dir", d, *stencil_flags(stencil), *flags]))
        if rc != 0:
            fail(f"{label}: cli.main returned {rc}")
        m = [re.search(r"(\d+) steps on \S+ grid in ([\d.]+)s\s+\(([\d.]+) "
                       r"Mcells/s\)", ln) for ln in lines]
        m = [x for x in m if x]
        if not m:
            fail(f"{label}: no Mcells/s line logged")
        steps, secs, mcells = int(m[-1][1]), float(m[-1][2]), float(m[-1][3])
        arrays, step, _ = checkpointing.load_any(d)
        fields = fields_from_numpy(arrays, device=dev)
        for f in fields:
            if tuple(f.shape) != tuple(grid) or \
                    not bool(torch.isfinite(f).all()):
                fail(f"{label}: final field not finite / wrong shape")
        runs[label] = {"fields": fields, "step": step}
        return {"label": label, "steps": steps, "seconds": secs,
                "mcells_per_s": mcells, "ms_per_step": 1e3 * secs / steps,
                "launches": got}

    def main_modes(stencil, k):
        """The unsharded main path's modes of a stencil: pallas only for
        those with a raw-step kernel (not SOR)."""
        if stencil in SOR:
            return ["jnp", str(k), "stream"]
        return ["jnp", "pallas", str(k), "stream"]

    results = []
    for stencil, iters, k in MAIN_RUNS + NEW_MAIN_RUNS + SOR_MAIN_RUNS:
        for label, mode, want in (
                ("jnp", ("--compute", "jnp"), {}),
                ("pallas", ("--compute", "pallas"), {raw_key(stencil): iters}),
                (str(k), ("--fuse", str(k)),
                 {f"fused_step[{stencil}]": iters // k}),
                ("stream", ("--fuse", str(k), "--fuse-kind", "stream"),
                 {f"stream_step[{stencil}]": iters // k})):
            if label not in main_modes(stencil, k):
                continue
            res = drive(f"{stencil}_{label}", stencil, *mode, iters=iters,
                        ckpt_every=iters)
            if res["launches"] != want:
                fail(f"{res['label']}: launches {res['launches']} != {want}")
            results.append(res)

    for stencil, iters, k in MAIN_RUNS + NEW_MAIN_RUNS + SOR_MAIN_RUNS:
        halo_w = make_stencil(stencil).halo
        ref = runs[f"{stencil}_jnp"]["fields"]
        frame = frame_of(MAIN, halo_w)
        scale = max(float(ref[0].abs().max()), 1.0)
        for mode, atol in (("pallas", 32 * EPS32 * scale), (str(k), 1e-4),
                           ("stream", 1e-4)):
            if mode not in main_modes(stencil, k):
                continue
            got = runs[f"{stencil}_{mode}"]["fields"]
            err = 0.0
            for g, r in zip(got, ref):
                err = max(err, float((g - r).abs().max()))
                if not torch.equal(g[frame], r[frame]):
                    fail(f"{stencil} {mode}: frame cells differ from jnp")
            if err > atol:
                fail(f"{stencil} {mode}: max|d| vs jnp {err:.3e} > {atol:.3e}")
            for r in results:
                if r["label"] == f"{stencil}_{mode}":
                    r["max_abs_err_vs_jnp"] = err
                    r["atol"] = atol
        for mode in main_modes(stencil, k):
            if f"{stencil}_{mode}" != "heat3d_pallas":  # kept for the resume
                del runs[f"{stencil}_{mode}"]["fields"]

    # checkpoint round trip: 50 steps + checkpoint, then resume to 100
    drive("ckpt_half", "heat3d", "--compute", "pallas", iters=ITERS // 2,
          ckpt_every=ITERS // 2)
    os.replace(os.path.join(scratch, "ckpt_half"),
               os.path.join(scratch, "ckpt_resumed"))
    resumed = drive("ckpt_resumed", "heat3d", "--compute", "pallas",
                    "--resume", ckpt_every=ITERS // 2)
    a, b = runs["ckpt_resumed"]["fields"], runs["heat3d_pallas"]["fields"]
    if resumed["steps"] != ITERS - ITERS // 2 or runs["ckpt_resumed"]["step"] != ITERS or \
            not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail("checkpoint round trip does not match the uninterrupted run")
    runs.clear()

    # 2D, BASELINE config 1: 512^2, 1000 iterations; Life from the
    # reference's random universe (density 0.15)
    frame512 = driver.frame_mask(BASE2D, BASE2D, (0, 0), 1, dev)
    for stencil, modes in (("heat2d", ("jnp", "pallas", str(FUSE2D))),
                           ("mdf", ("jnp", str(FUSE2D))),
                           ("life", ("jnp", "pallas", str(FUSE2D)))):
        name = make_stencil(stencil).name
        init = (("--init", "random", "--density", "0.15")
                if stencil == "life" else ())
        for mode in modes:
            flags = ("--fuse", mode) if mode.isdigit() else ("--compute", mode)
            res = drive(f"{stencil}_{mode}", stencil, *flags, *init,
                        iters=ITERS2D, ckpt_every=ITERS2D, grid=BASE2D)
            want = {"jnp": {}, "pallas": {f"whole2d[{name}]": ITERS2D}}.get(
                mode, {f"fullgrid_step[{name}]": ITERS2D // FUSE2D})
            if res["launches"] != want:
                fail(f"{res['label']}: launches {res['launches']} != {want}")
            if mode != "jnp":
                ref = runs[f"{stencil}_jnp"]["fields"]
                got = runs[f"{stencil}_{mode}"]["fields"]
                scale = max(float(ref[0].abs().max()), 1.0)
                atol = (0.0 if name == "life" else
                        1e-4 if mode.isdigit() else 32 * EPS32 * scale)
                err = max(float((g - r).abs().max()) for g, r in
                          zip(got, ref))
                if err > atol or not all(torch.equal(g[frame512], r[frame512])
                                         for g, r in zip(got, ref)):
                    fail(f"{stencil} {mode}: max|d| vs jnp {err:.3e} > "
                         f"{atol:.3e}, or frame cells differ")
                res["max_abs_err_vs_jnp"], res["atol"] = err, atol
            results.append(res)
        runs.clear()

    # sor2d at BASE2D as a solver: --fuse 8 --tol against its jnp twin, the
    # same converged step (checkpointed) and the same fields
    tol, every, cap = SOR_TOL
    tol_flags = ("--tol", tol, "--tol-check-every", str(every))
    sor_tol = {}
    for mode, flags in (("jnp", ("--compute", "jnp")),
                        (str(FUSE2D), ("--fuse", str(FUSE2D)))):
        d = os.path.join(scratch, f"sor2d_tol_{mode}")
        lines.clear()
        rc, got = counted(lambda: cli.main(
            ["--stencil", "sor2d", "--grid", ",".join(map(str, BASE2D)),
             "--iters", str(cap), "--checkpoint-dir", d, *flags,
             *tol_flags]))
        m = [re.search(r"converged=(\w+) after (\d+) steps \(residual "
                       r"(\S+), tol \S+\) in ([\d.]+)s", ln) for ln in lines]
        m = [x for x in m if x]
        if rc != 0 or not m:
            fail(f"sor2d --tol {mode}: rc {rc}, no converged= line")
        arrays, step, _ = checkpointing.load_any(d)
        steps = int(m[-1][2])
        if step != steps:
            fail(f"sor2d --tol {mode}: checkpoint at {step}, run {steps}")
        want = {} if mode == "jnp" else {
            "fullgrid_step[sor2d]": steps // FUSE2D}
        if got != want:
            fail(f"sor2d --tol {mode}: launches {got} != {want}")
        sor_tol[mode] = (fields_from_numpy(arrays, device=dev)[0], {
            "label": f"sor2d_tol_{mode}", "converged": m[-1][1] == "True",
            "steps": steps, "residual": float(m[-1][3]),
            "seconds": float(m[-1][4]),
            "ms_per_step": 1e3 * float(m[-1][4]) / max(steps, 1),
            "launches": got, "tol": float(tol), "check_every": every})
    (ref, rj), (got, rf) = sor_tol["jnp"], sor_tol[str(FUSE2D)]
    err = float((got - ref).abs().max())
    if rf["steps"] != rj["steps"] or err > 1e-4 or \
            not torch.equal(got[frame512], ref[frame512]):
        fail(f"sor2d --tol: fused {rf['steps']} steps vs jnp {rj['steps']},"
             f" max|d| {err:.3e}")
    rf["max_abs_err_vs_jnp"], rf["atol"] = err, 1e-4
    results += [rj, rf]
    del sor_tol, ref, got
    emit({"phase": "main_path", "ok": True, "seconds": took(),
          "grid": list(MAIN), "iters": ITERS, "grid_2d": list(BASE2D),
          "iters_2d": ITERS2D, "runs": results,
          "launches": dict(main_launches),
          "checkpoint_roundtrip": "bit-exact"})
    torch.cuda.empty_cache()

    # ---- 5. sharded main path ----------------------------------------------
    os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = "4"
    mesh_results = []

    def run_cli(stencil, grid, iters, *flags, init=None):
        """One ``cli.run()``; ``init`` defaults to the family's own for
        advection and Gray-Scott (its patch), ``pulse`` for the rest."""
        if init is None:
            init = "auto" if stencil in NEW_FAMILIES else "pulse"
        argv = ["--stencil", stencil, "--grid", ",".join(map(str, grid)),
                "--iters", str(iters), "--init", init,
                *stencil_flags(stencil), *flags]
        s0 = torch.cuda.memory_stats()
        (fields, mcells), got = counted(
            lambda: cli.run(cli.config_from_args(argv)))
        torch.cuda.synchronize()
        s1 = torch.cuda.memory_stats()
        cells = math.prod(grid)
        res = {"stencil": stencil, "grid": list(grid), "iters": iters,
               "flags": list(flags), "mcells_per_s": mcells,
               "ms_per_step": 1e3 * cells / (mcells * 1e6),
               "launches": got,
               # the caching allocator's cudaMalloc calls and free-and-retry
               # events over the run (0 and 0 once its pool is warm)
               "cuda_mallocs": s1["segment.all.allocated"]
               - s0["segment.all.allocated"],
               "alloc_retries": s1["num_alloc_retries"]
               - s0["num_alloc_retries"]}
        return fields, res

    def block_err(sharded, ref, frame_w, what):
        """max |d| of sharded fields against whole ones, frame exact."""
        err = 0.0
        for sf, r in zip(sharded, ref):
            local = tuple(sf[0].shape)
            for c, blk in zip(sf.mesh.coords(), sf):
                sl = stepper.block_slices(c, local)
                rb = r[sl]
                if not bool(torch.isfinite(blk).all()):
                    fail(f"{what}: non-finite values")
                err = max(err, float((blk.float() - rb.float()).abs().max()))
                if frame_w:
                    fm = driver.frame_mask(
                        local, sf.global_shape,
                        stepper.shard_offsets(c, local), frame_w, dev)
                    if not torch.equal(blk[fm], rb[fm]):
                        fail(f"{what}: frame cells differ")
        return err

    def check(res, err, atol, what):
        res.setdefault("max_abs_err", {})[what] = err
        if err > atol:
            fail(f"{res['stencil']} {res['flags']}: max|d| vs {what} "
                 f"{err:.3e} > {atol:.3e}")

    for stencil, grid, iters, k, overlapped in (MESH_RUNS + NEW_MESH_RUNS
                                                + SOR_MESH_RUNS):
        st = make_stencil(stencil)
        h = st.halo
        new_family = stencil in NEW_FAMILIES
        zkey = ("zchunk_wave" if stencil == "wave3d"
                else "zchunk_heat") + f"[{stencil}]"
        big = grid == BIG
        passes = iters // k
        refs = {}  # unsharded runs of each mode: the same-mode yardsticks

        def unsharded(label, flags, want):
            refs[label], r = run_cli(stencil, grid, iters, *flags)
            if r["launches"] != want:
                fail(f"{stencil} unsharded {label}: launches "
                     f"{r['launches']} != {want}")
            if label != "plain":
                atol = 32 * EPS32 * scale if label == "pallas" else 1e-4
                check(r, max(float((x - y).abs().max())
                             for x, y in zip(refs[label], refs["plain"])),
                      atol, "unsharded plain")
            mesh_results.append(r)

        refs["plain"], r = run_cli(stencil, grid, iters, "--compute", "jnp")
        mesh_results.append(r)
        scale = max(float(refs["plain"][0].abs().max()), 1.0)
        if stencil not in NO_COMPUTE_FN:  # pallas: the mesh modes' yardstick
            unsharded("pallas", ("--compute", "pallas"),
                      {raw_key(stencil): iters})
        unsharded("fuse", ("--fuse", str(k)),
                  {f"fused_step[{stencil}]": passes})
        padded, zslab, yzslab, shell, szslab, syzslab = (
            f"{w}[{stencil}]" for w in ("fused_step_padded", "fused_zslab",
                                        "fused_yzslab", "fused_shell",
                                        "stream_zslab", "stream_yzslab"))
        fuse22 = ("--mesh", "2,2", "--fuse", str(k))
        fuse4 = ("--mesh", "4", "--fuse", str(k), "--fuse-kind", "padfree")
        yz22 = fuse22 + ("--fuse-kind", "padfree")
        s22 = fuse22 + ("--fuse-kind", "stream")
        s4 = ("--mesh", "4", "--fuse", str(k), "--fuse-kind", "stream")
        rdma = ("--exchange", "rdma")
        # the ring sites of one field's exchange: on 2x2 the z and y slabs
        # and the corners (two launches), on --mesh 4 the z slabs
        m = k_step_margin(st, k)
        Lz, Ly, X = grid[0] // 2, grid[1] // 2, grid[2]
        nf = st.num_fields
        ring22 = {f"ring_exchange[{m}x{Ly}x{X}]": nf * passes,
                  f"ring_exchange[{Lz}x{m}x{X}]": nf * passes,
                  f"ring_exchange[{m}x{m}x{X}]": 2 * nf * passes}
        ring4 = {f"ring_exchange[{m}x{grid[1]}x{X}]": nf * passes}
        # (label, flags, launches): 4 shards, one shell per sharded face
        modes = [("jnp", ("--mesh", "2,2", "--compute", "jnp"), {}),
                 ("pallas", ("--mesh", "2,2", "--compute", "pallas"),
                  {zkey: 4 * iters}),
                 ("overlap", ("--mesh", "2,2", "--compute", "pallas",
                              "--overlap"), {zkey: 4 * iters + 16 * iters}),
                 ("fuse", fuse22, {padded: 4 * passes}),
                 ("fuse_overlap", fuse22 + ("--overlap",),
                  {padded: 4 * passes, shell: 16 * passes}),
                 ("padfree", fuse4, {zslab: 4 * passes}),
                 ("padfree_overlap", fuse4 + ("--overlap",),
                  {zslab: 4 * passes, shell: 8 * passes}),
                 ("yzslab", yz22, {yzslab: 4 * passes}),
                 ("yzslab_overlap", yz22 + ("--overlap",),
                  {yzslab: 4 * passes, shell: 16 * passes}),
                 ("stream_yz", s22, {syzslab: 4 * passes}),
                 ("rdma_yz", s22 + rdma, {syzslab: 4 * passes, **ring22}),
                 ("stream_yz_overlap", s22 + ("--overlap",),
                  {syzslab: 4 * passes, shell: 16 * passes}),
                 ("rdma_yz_overlap", s22 + rdma + ("--overlap",),
                  {syzslab: 4 * passes, shell: 16 * passes, **ring22}),
                 ("stream_z", s4, {szslab: 4 * passes}),
                 ("rdma_z", s4 + rdma, {szslab: 4 * passes, **ring4})]
        modes = [md for md in modes if md[0] in overlapped or (
            md[0] not in TWIN
            and (big or new_family or md[0] not in ("padfree", "stream_z")))]
        if new_family:  # no compute_fn kernel, no one-step overlap
            modes = [md for md in modes
                     if md[0] in ("jnp", "fuse", "fuse_overlap", "stream_yz",
                                  "rdma_yz", "stream_z", "padfree",
                                  "yzslab") + NEW_PADFREE]
        if stencil in NO_COMPUTE_FN:  # no compute_fn kernel: no pallas
            modes = [md for md in modes if md[0] != "pallas"]
        kept = {}
        # runs still to come that must equal this one bit for bit
        pending = {}
        for md in modes:
            if md[0] in TWIN:
                pending[TWIN[md[0]]] = pending.get(TWIN[md[0]], 0) + 1
        for label, flags, want in modes:
            if label.startswith(("stream", "rdma")) and "stream" not in refs:
                # the stream modes come last: their yardstick replaces the
                # other kernels' on the card
                refs.pop("pallas", None)
                del refs["fuse"]
                torch.cuda.empty_cache()
                unsharded("stream", ("--fuse", str(k), "--fuse-kind",
                                     "stream"),
                          {f"stream_step[{stencil}]": passes})
            got, r = run_cli(stencil, grid, iters, *flags)
            if r["launches"] != want:
                fail(f"{stencil} {label}: launches {r['launches']} != {want}")
            if label.startswith(("stream", "rdma")):
                atol, same = 1e-4, refs["stream"]
            elif "--fuse" in flags:
                atol, same = 1e-4, refs["fuse"]
            elif label == "jnp":
                atol, same = 32 * EPS32 * scale, refs["plain"]
            else:
                atol, same = 1e-6 + 1e-6 * scale, refs["pallas"]
            check(r, block_err(got, same, h, f"{stencil} {label}"), atol,
                  "unsharded same mode")
            check(r, block_err(got, refs["plain"], h, f"{stencil} {label}"),
                  max(atol, 32 * EPS32 * scale), "unsharded plain")
            if label in TWIN:
                twin = TWIN[label]
                base = kept[twin]
                if not all(torch.equal(x, y) for a, b in zip(got, base)
                           for x, y in zip(a, b)):
                    fail(f"{stencil} {label}: differs from {twin}")
                r["bit_equal_to_" + ("ppermute" if label in RDMA_BASE
                                     else "non_overlap")] = True
                pending[twin] -= 1
                if not pending[twin]:
                    del kept[twin]
                del base
            if pending.get(label):
                kept[label] = got
            mesh_results.append(r)
            del got
            torch.cuda.empty_cache()
        del refs, same
        torch.cuda.empty_cache()

    # sharded checkpoint round trip at 512^3 on 2x2 through cli.main()
    grid2 = ("--mesh", "2,2", "--compute", "pallas")
    drive("mesh_full", "heat3d", *grid2, "--init", "pulse")
    drive("mesh_half", "heat3d", *grid2, "--init", "pulse", iters=ITERS // 2,
          ckpt_every=ITERS // 2)
    os.replace(os.path.join(scratch, "mesh_half"),
               os.path.join(scratch, "mesh_resumed"))
    resumed = drive("mesh_resumed", "heat3d", *grid2, "--init", "pulse",
                    "--resume", ckpt_every=ITERS // 2)
    a, b = runs["mesh_resumed"]["fields"], runs["mesh_full"]["fields"]
    if resumed["steps"] != ITERS - ITERS // 2 or runs["mesh_resumed"]["step"] != ITERS or \
            not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail("sharded checkpoint round trip does not match the "
             "uninterrupted run")
    runs.clear()

    # 2D at 16384^2, 96 iterations: unsharded references, then --mesh 4 (a
    # row split; life also --mesh 2, the reference's two-rank program)
    def err_whole(got, ref):
        return max(float((g.float() - r.float()).abs().max())
                   for g, r in zip(got, ref))

    for stencil, init in (("life", "random"), ("heat2d", "pulse")):
        k = FUSE2D
        whole, padded = f"whole2d[{stencil}]", f"fullgrid_padded[{stencil}]"
        refs = {}
        for label, flags, want in (
                ("jnp", ("--compute", "jnp"), {}),
                ("pallas", ("--compute", "pallas"), {whole: ITERS16K}),
                ("fuse", ("--fuse", str(k)),
                 {f"fullgrid_step[{stencil}]": ITERS16K // k})):
            got, r = run_cli(stencil, GRID2D, ITERS16K, *flags, init=init)
            if r["launches"] != want:
                fail(f"{stencil} 2D unsharded {label}: launches "
                     f"{r['launches']} != {want}")
            if label != "jnp":
                scale = max(float(refs["jnp"][0].abs().max()), 1.0)
                atol = (0.0 if stencil == "life" else 1e-4 if label == "fuse"
                        else 32 * EPS32 * scale)
                check(r, err_whole(got, refs["jnp"]), atol, "unsharded plain")
            refs[label] = got
            mesh_results.append(r)
        scale = max(float(refs["jnp"][0].abs().max()), 1.0)
        modes = [("jnp", ("--mesh", "4", "--compute", "jnp"), {}, "jnp"),
                 ("pallas", ("--mesh", "4", "--compute", "pallas"),
                  {whole: 4 * ITERS16K}, "pallas"),
                 ("overlap", ("--mesh", "4", "--compute", "pallas",
                              "--overlap"), {whole: 12 * ITERS16K}, "pallas"),
                 ("fuse", ("--mesh", "4", "--fuse", str(k)),
                  {padded: 4 * ITERS16K // k}, "fuse"),
                 ("fuse_overlap", ("--mesh", "4", "--fuse", str(k),
                                   "--overlap"),
                  {padded: 12 * ITERS16K // k}, "fuse")]
        if stencil == "life":
            modes.append(("mesh2_overlap", ("--mesh", "2", "--compute",
                                            "pallas", "--overlap"),
                          {whole: 6 * ITERS16K}, "pallas"))
        kept = {}
        for label, flags, want, same in modes:
            got, r = run_cli(stencil, GRID2D, ITERS16K, *flags, init=init)
            if r["launches"] != want:
                fail(f"{stencil} 2D {label}: launches {r['launches']} != "
                     f"{want}")
            atol = {"jnp": 32 * EPS32 * scale, "fuse": 1e-4,
                    "pallas": 1e-6 + 1e-6 * scale}[same]
            if stencil == "life":
                atol = 0.0
            check(r, block_err(got, refs[same], 1, f"{stencil} {label}"),
                  atol, "unsharded same mode")
            check(r, block_err(got, refs["jnp"], 1, f"{stencil} {label}"),
                  max(atol, 0.0 if stencil == "life" else 32 * EPS32 * scale),
                  "unsharded plain")
            if label in ("pallas", "fuse"):
                kept[label] = got
            elif label in ("overlap", "fuse_overlap"):
                base = kept.pop("pallas" if label == "overlap" else "fuse")
                if not all(torch.equal(x, y) for a, b in zip(got, base)
                           for x, y in zip(a, b)):
                    fail(f"{stencil} 2D {label}: differs from non-overlap")
                r["bit_equal_to_non_overlap"] = True
            mesh_results.append(r)
            del got
        del refs, kept
        torch.cuda.empty_cache()
    got, r = run_cli("wave2d", GRID2D, ITERS16K, "--compute", "jnp")
    mesh_results.append(r)
    fgot, r = run_cli("wave2d", GRID2D, ITERS16K, "--fuse", str(FUSE2D))
    if r["launches"] != {"fullgrid_step[wave2d]": ITERS16K // FUSE2D}:
        fail(f"wave2d fuse: launches {r['launches']}")
    check(r, err_whole(fgot, got), 1e-4, "unsharded plain")
    mesh_results.append(r)
    del got, fgot
    torch.cuda.empty_cache()

    # advection, Gray-Scott and SOR at 16384^2: jnp and --fuse 8
    # unsharded, and grayscott2d (two 1.07 GB fields, both exchanged) and
    # sor2d (a red and a black half-sweep a step, margin 2k) on --mesh 4
    # with --fuse 8, with and without --overlap
    for stencil in ("advect2d", "grayscott2d", "sor2d"):
        k = FUSE2D
        passes = ITERS16K // k
        got, r = run_cli(stencil, GRID2D, ITERS16K, "--compute", "jnp")
        mesh_results.append(r)
        scale = max(float(got[0].abs().max()), 1.0)
        fgot, r = run_cli(stencil, GRID2D, ITERS16K, "--fuse", str(k))
        if r["launches"] != {f"fullgrid_step[{stencil}]": passes}:
            fail(f"{stencil} fuse: launches {r['launches']}")
        check(r, err_whole(fgot, got), 1e-4, "unsharded plain")
        mesh_results.append(r)
        base = None
        padded = f"fullgrid_padded[{stencil}]"
        mesh_modes = (("fuse", (), {padded: 4 * passes}),
                      ("fuse_overlap", ("--overlap",), {padded: 12 * passes}))
        for label, flags, want in (mesh_modes if stencil != "advect2d"
                                   else ()):
            mgot, r = run_cli(stencil, GRID2D, ITERS16K, "--mesh", "4",
                              "--fuse", str(k), *flags)
            if r["launches"] != want:
                fail(f"{stencil} 2D {label}: launches {r['launches']} != "
                     f"{want}")
            check(r, block_err(mgot, fgot, 1, f"{stencil} {label}"), 1e-4,
                  "unsharded same mode")
            check(r, block_err(mgot, got, 1, f"{stencil} {label}"),
                  max(1e-4, 32 * EPS32 * scale), "unsharded plain")
            if base is None:
                base = mgot
            else:
                if not all(torch.equal(x, y) for a, b in zip(mgot, base)
                           for x, y in zip(a, b)):
                    fail(f"{stencil} 2D {label}: differs from non-overlap")
                r["bit_equal_to_non_overlap"] = True
            mesh_results.append(r)
            del mgot
        del got, fgot, base
        torch.cuda.empty_cache()

    # 2D sharded checkpoint round trip: Life --mesh 4 --fuse 8 at 4096^2,
    # 48 steps + checkpoint, then resume to 96 (multiples of k = 8)
    life_grid = LIFE_CKPT_GRID
    life2 = ("--mesh", "4", "--fuse", str(FUSE2D))
    drive("life_full", "life", *life2, iters=96, ckpt_every=96,
          grid=life_grid)
    drive("life_half", "life", *life2, iters=48, ckpt_every=48,
          grid=life_grid)
    os.replace(os.path.join(scratch, "life_half"),
               os.path.join(scratch, "life_resumed"))
    resumed = drive("life_resumed", "life", *life2, "--resume",
                    iters=96, ckpt_every=48, grid=life_grid)
    a, b = runs["life_resumed"]["fields"], runs["life_full"]["fields"]
    if resumed["steps"] != 48 or runs["life_resumed"]["step"] != 96 or \
            not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail("2D sharded checkpoint round trip does not match the "
             "uninterrupted run")
    shutil.rmtree(scratch, ignore_errors=True)
    runs.clear()
    emit({"phase": "sharded_main_path", "ok": True, "seconds": took(),
          "note": "4 shards on 1 card: decomposition overhead, not scaling",
          "runs": mesh_results, "checkpoint_roundtrip": "bit-exact",
          "launches": dict(main_launches)})
    torch.cuda.empty_cache()

    # ---- 5b. the bfloat16 main path -----------------------------------------
    # Every kernel that takes bfloat16, through cli.run(): at 512^3 for
    # BF16_ITERS iterations every K10 family with --compute pallas (the raw
    # kinds), the stream kind unsharded, on --mesh 4 and on --mesh 2,2
    # --exchange rdma; heat3d and wave3d at 1024^3 for ITERS with --compute
    # pallas, the stream kind and --mesh 2,2 stream with and without
    # --exchange rdma, beside their f32 twins of phase 5; the compute_fn
    # kernels on --mesh 2,2 and --periodic, and the 2D kernels K7 and K8 at
    # 16384^2.  Every kernel run is held bit for bit (max |d| = 0) to the
    # plain bf16 run.
    bf16_results = []
    dt16 = ("--dtype", BF16)

    def ring_sites(grid, mshape, m, nf, passes):
        """The ring launches of one bf16 run: per field and pass, on 2x2
        the z and y slab and two corner launches, on --mesh 4 the z slab."""
        X = grid[2]
        if mshape == "4":
            return {f"ring_exchange[{m}x{grid[1]}x{X},{BF16}]": nf * passes}
        Lz, Ly = grid[0] // 2, grid[1] // 2
        return {f"ring_exchange[{m}x{Ly}x{X},{BF16}]": nf * passes,
                f"ring_exchange[{Lz}x{m}x{X},{BF16}]": nf * passes,
                f"ring_exchange[{m}x{m}x{X},{BF16}]": 2 * nf * passes}

    def fuse_modes(name, kf, passes, group):
        """The K3 / K6 / K9 modes of a bf16 run at --fuse kf: ``group``
        "main" (unsharded K3; advect3d and grayscott3d also pad-free on
        --mesh 2,2 and --mesh 4 with and without --overlap) or "big" (the
        1024^3 runs: unsharded, --mesh 2,2 padded, pad-free and stream
        with and without --overlap, --mesh 4 pad-free).  Shells: one a
        face of each sharded axis and shard."""
        def key(w):
            return f"{w}[{name},{BF16}]"

        fuse = ("--fuse", str(kf))
        m22 = ("--mesh", "2,2") + fuse
        yz22 = m22 + ("--fuse-kind", "padfree")
        z4 = ("--mesh", "4") + fuse + ("--fuse-kind", "padfree")
        over = ("--overlap",)
        shell22 = {key("fused_shell"): 16 * passes}
        modes = [("fuse", fuse, {key("fused_step"): passes})]
        if group == "big":
            modes += [("fuse22", m22, {key("fused_step_padded"): 4 * passes}),
                      ("fuse22_overlap", m22 + over,
                       {key("fused_step_padded"): 4 * passes, **shell22}),
                      ("stream_yz", m22 + ("--fuse-kind", "stream"),
                       {key("stream_yzslab"): 4 * passes}),
                      ("stream_yz_overlap", m22 + ("--fuse-kind", "stream")
                       + over, {key("stream_yzslab"): 4 * passes,
                                **shell22})]
        if group == "big" or name in ("advect3d", "grayscott3d"):
            modes += [("yzslab", yz22, {key("fused_yzslab"): 4 * passes}),
                      ("yzslab_overlap", yz22 + over,
                       {key("fused_yzslab"): 4 * passes, **shell22}),
                      ("padfree", z4, {key("fused_zslab"): 4 * passes})]
        if name in ("advect3d", "grayscott3d"):
            modes.append(("padfree_overlap", z4 + over,
                          {key("fused_zslab"): 4 * passes,
                           key("fused_shell"): 8 * passes}))
        return modes

    def bf16_modes(name, k, grid, iters, big):
        st = make_stencil(name, dtype=BF16)
        m, nf, passes = k_step_margin(st, k), st.num_fields, iters // k

        def key(w):
            return f"{w}[{name},{BF16}]"

        stream = ("--fuse", str(k), "--fuse-kind", "stream")
        rdma = ("--exchange", "rdma")
        modes = [] if name == "sor3d" else [
            ("pallas", ("--compute", "pallas"), {raw_key(name, BF16): iters})]
        modes.append(("stream", stream, {key("stream_step"): passes}))
        # the same run on K10's per-cell path (every fast path off)
        modes.append(("stream_percell", stream, {key("stream_step"): passes}))
        if name in ("heat3d", "heat3d27", "heat3d4th", "wave3d"):
            # BASELINE config 3's decomposition: K4 / K5 on 2x2
            p22 = ("--mesh", "2,2", "--compute", "pallas")
            z = zchunk_key(name, BF16)
            modes.append(("pallas22", p22, {z: 4 * iters}))
            if big:
                modes.append(("pallas22_overlap", p22 + ("--overlap",),
                              {z: 20 * iters}))
        if big:
            s22 = ("--mesh", "2,2") + stream
            modes += [("stream_yz", s22, {key("stream_yzslab"): 4 * passes}),
                      ("rdma_yz", s22 + rdma,
                       {key("stream_yzslab"): 4 * passes,
                        **ring_sites(grid, "2,2", m, nf, passes)})]
        else:
            modes += [("stream_z", ("--mesh", "4") + stream,
                       {key("stream_zslab"): 4 * passes}),
                      ("rdma_yz", ("--mesh", "2,2") + stream + rdma,
                       {key("stream_yzslab"): 4 * passes,
                        **ring_sites(grid, "2,2", m, nf, passes)})]
            kf = BF16_FUSE[name]
            modes += fuse_modes(name, kf, iters // kf, "main")
        return st, modes

    def f32_twin(name, grid, flags):
        """The ms/step of a run's float32 twin in phase 5: the same grid
        and flags, at the float32 k (3D --fuse 4 where the bf16 run takes
        --fuse 8, 2D --fuse 8)."""
        want = list(flags)
        for i in range(len(want) - 1):
            if want[i] == "--fuse":
                want[i + 1] = str(FUSE2D) if len(grid) == 2 else \
                    {"8": "4"}.get(want[i + 1], want[i + 1])
        twin = [t for t in mesh_results if t["stencil"] == name
                and t["grid"] == list(grid) and t["flags"] == want]
        return twin[0]["ms_per_step"] if twin else None

    def bf16_group(name, grid, iters, st, modes, twins, ref_flags=()):
        """The plain bf16 run of ``name`` at ``grid`` (with ``ref_flags``),
        then each mode, held to it bit for bit and each ``*_overlap`` mode
        to its base; with ``twins`` each run records its f32 twin's
        ms/step."""
        ref, r = run_cli(name, grid, iters, "--compute", "jnp", *dt16,
                         *ref_flags)
        bf16_results.append(r)
        kept = {}  # the non-overlap run each --overlap run must equal
        for label, flags, want in modes:
            # a *_percell mode runs K10 and K8 with every fast path off
            percell = label.endswith("_percell")
            saved = streamfused.PATHS, fullgrid.PATHS
            if percell:
                streamfused.PATHS = fullgrid.PATHS = 0
            try:
                got, r = run_cli(name, grid, iters, *flags, *dt16)
            finally:
                streamfused.PATHS, fullgrid.PATHS = saved
            r["per_cell_path"] = percell
            if r["launches"] != want:
                fail(f"{name} bf16 {label}: launches {r['launches']} != "
                     f"{want}")
            err = (block_err(got, ref, st.halo, f"{name} bf16 {label}")
                   if stepper.is_sharded(got) else err_whole(got, ref))
            check(r, err, 0.0, "plain bf16 run")
            base = label[:-len("_overlap")] if label.endswith("_overlap") \
                else None
            if base in kept:
                if not all(torch.equal(x, y) for a, b in zip(got, kept[base])
                           for x, y in zip(a, b)):
                    fail(f"{name} bf16 {label}: differs from {base}")
                r["bit_equal_to_non_overlap"] = True
                del kept[base]
            elif any(md[0] == f"{label}_overlap" for md in modes):
                kept[label] = got
            if twins or label.startswith("pallas22"):
                # the f32 twin of phase 5 (same grid and flags, f32 k)
                r["f32_twin_ms_per_step"] = f32_twin(name, grid, flags)
            bf16_results.append(r)
            del got
        del ref, kept
        torch.cuda.empty_cache()

    runs16 = ([(n, k, MAIN, BF16_ITERS, None) for n, k in BF16_FAMILIES]
              + [(n, 4, BIG, ITERS, None) for n in ("heat3d", "wave3d")]
              + [(n, 8, BIG, ITERS16K, "big") for n in ("heat3d", "wave3d")])
    for name, k, grid, iters, group in runs16:
        big = grid == BIG
        if group:
            st = make_stencil(name, dtype=BF16)
            modes = fuse_modes(name, k, iters // k, group)
        else:
            st, modes = bf16_modes(name, k, grid, iters, big)
        bf16_group(name, grid, iters, st, modes,
                   big or name in ("advect3d", "grayscott3d"))
    # --periodic --compute pallas (K4 / K5 on the wrap-padded grid) at
    # 512^3 for ITERS, beside its f32 run
    for name in ("heat3d", "wave3d"):
        per = ("--periodic", "--compute", "pallas")
        _, r = run_cli(name, MAIN, ITERS, *per)
        if r["launches"] != {zchunk_key(name): ITERS}:
            fail(f"{name} f32 periodic pallas: launches {r['launches']}")
        mesh_results.append(r)
        bf16_group(name, MAIN, ITERS, make_stencil(name, dtype=BF16),
                   [("periodic_pallas", per,
                     {zchunk_key(name, BF16): ITERS})], True,
                   ref_flags=("--periodic",))
    # 2D at 16384^2 for ITERS16K: K7 (heat2d and mdf --compute pallas,
    # heat2d also on --mesh 4 with and without --overlap) and K8 (every
    # float family at its BF16_FUSE2D k, unsharded and on --mesh 4 with and
    # without --overlap), beside their f32 twins of phase 5 (--fuse 8)
    for name, k in BF16_FUSE2D.items():
        passes = ITERS16K // k

        def key(w, name=name):
            return f"{w}[{name},{BF16}]"

        m4 = ("--mesh", "4", "--fuse", str(k))
        modes = [("fuse", ("--fuse", str(k)), {key("fullgrid_step"): passes}),
                 ("fuse_percell", ("--fuse", str(k)),
                  {key("fullgrid_step"): passes}),
                 ("fuse4", m4, {key("fullgrid_padded"): 4 * passes}),
                 ("fuse4_overlap", m4 + ("--overlap",),
                  {key("fullgrid_padded"): 12 * passes})]
        if name == "heat2d":
            m4 = ("--mesh", "4", "--compute", "pallas")
            modes = [("pallas", ("--compute", "pallas"),
                      {key("whole2d"): ITERS16K}),
                     ("pallas4", m4, {key("whole2d"): 4 * ITERS16K}),
                     ("pallas4_overlap", m4 + ("--overlap",),
                      {key("whole2d"): 12 * ITERS16K})] + modes
        bf16_group(name, GRID2D, ITERS16K,
                   make_stencil(name, dtype=BF16), modes, True)
    # mdf: heat2d under its other registry name, the same fields bit for bit
    ref, _ = run_cli("heat2d", GRID2D, ITERS16K, "--compute", "jnp", *dt16)
    got, r = run_cli("mdf", GRID2D, ITERS16K, "--compute", "pallas", *dt16)
    if r["launches"] != {f"whole2d[heat2d,{BF16}]": ITERS16K}:
        fail(f"mdf bf16 pallas: launches {r['launches']}")
    check(r, err_whole(got, ref), 0.0, "plain bf16 heat2d run")
    bf16_results.append(r)
    del ref, got
    emit({"phase": "bf16_main_path", "ok": True, "seconds": took(),
          "note": "every kernel run bit-equal to the plain bf16 run",
          "runs": bf16_results})

    # ---- 5c. BASELINE config 5 ---------------------------------------------
    from mpi_cuda_process_tpu_torch.utils import budget

    c5 = {}
    # the rehearsal line on 8 virtual shards against the plain bf16 run
    os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = "8"
    rgrid = (192, 64, 128)
    flags = CONFIG5_REHEARSAL[4:]
    got, r = run_cli("wave3d", rgrid, 8, *flags, init="auto")
    if r["launches"] != {f"stream_zslab[wave3d,{BF16}]": 16}:
        fail(f"config 5 rehearsal: launches {r['launches']}")
    ref, _ = run_cli("wave3d", rgrid, 8, "--compute", "jnp", *dt16,
                     init="auto")
    check(r, block_err(got, ref, 1, "config 5 rehearsal"), 1e-3,
          "plain bf16 run")
    c5["rehearsal"] = r
    # with --overlap: the K3 shells would have m = 4, off bfloat16's
    # alignment unit, so the run logs the fallback (as the JAX CLI does)
    # and runs the non-split step: bit-equal to the line without it
    lines.clear()
    over, r = run_cli("wave3d", rgrid, 8, *flags, "--overlap", init="auto")
    if not any("cannot host the interior/boundary split" in ln
               for ln in lines):
        fail("config 5 rehearsal --overlap: no fallback line logged")
    if r["launches"] != {f"stream_zslab[wave3d,{BF16}]": 16}:
        fail(f"config 5 rehearsal --overlap: launches {r['launches']}")
    if not all(torch.equal(x, y) for a, b in zip(over, got)
               for x, y in zip(a, b)):
        fail("config 5 rehearsal --overlap differs from the line without it")
    r.update(fallback_logged=True, bit_equal_to_non_overlap=True)
    c5["rehearsal_overlap"] = r
    del got, ref, over
    # one card's share of the full-width run: 4 of 64 shards, 1.07e9
    # cells each, against the unsharded stream run of the same grid
    os.environ[mesh_lib.VIRTUAL_DEVICES_ENV] = "4"
    grid5 = CONFIG5_GRID
    stream5 = ("--fuse", "4", "--fuse-kind", "stream")
    st16 = make_stencil("wave3d", dtype=BF16)

    def measured(fn):
        """(result, this run's peak bytes above what was held before)."""
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - held

    torch.cuda.empty_cache()
    (whole, r), peak = measured(lambda: run_cli(
        "wave3d", grid5, CONFIG5_ITERS, *stream5, *dt16, init="auto"))
    r.update(peak_bytes=peak, estimate_bytes=budget.estimate_run_bytes(
        st16, grid5, fuse=4, fuse_kind="stream")[0])
    c5["unsharded"] = r
    for exchange in ("ppermute", "rdma"):
        lines.clear()
        (got, r), peak = measured(lambda: run_cli(
            "wave3d", grid5, CONFIG5_ITERS, "--mesh", "4,1,1", *stream5,
            *dt16, "--mem-check", "error", "--exchange", exchange,
            init="auto"))
        est, parts = budget.estimate_run_bytes(
            st16, grid5, mesh=(4, 1, 1), fuse=4, fuse_kind="stream",
            exchange=exchange, shards_per_device=4)
        logged = [ln for ln in lines if ln.startswith("memory budget")]
        if not logged:
            fail(f"config 5 {exchange}: no memory budget line logged")
        passes = CONFIG5_ITERS // 4
        want = {f"stream_zslab[wave3d,{BF16}]": 4 * passes}
        if exchange == "rdma":
            want[f"ring_exchange[4x{grid5[1]}x{grid5[2]},{BF16}]"] = \
                2 * passes
        if r["launches"] != want:
            fail(f"config 5 {exchange}: launches {r['launches']} != {want}")
        if exchange == "rdma" and peak > est:
            fail(f"config 5 rdma: peak {peak} B above the estimate {est} B")
        check(r, block_err(got, whole, 1, f"config 5 {exchange}"), 0.0,
              "unsharded stream run")
        r.update(peak_bytes=peak, estimate_bytes=est, budget_log=logged[-1],
                 budget_parts=[[lb, b] for lb, b in parts])
        c5[exchange] = r
        del got
    c5["rdma_bit_equal_to_ppermute"] = True  # both equal the unsharded run
    del whole
    torch.cuda.empty_cache()
    # its float32 twin, where the budget admits it on this card
    st32 = make_stencil("wave3d")
    try:
        budget.check_budget(st32, grid5, mesh=(4, 1, 1), fuse=4,
                            fuse_kind="stream", shards_per_device=4)
    except ValueError as refusal:
        c5["float32"] = {"refused_by_mem_check": str(refusal)}
    else:
        (got, r), peak = measured(lambda: run_cli(
            "wave3d", grid5, CONFIG5_ITERS, "--mesh", "4,1,1", *stream5,
            "--mem-check", "error", init="auto"))
        r.update(peak_bytes=peak, estimate_bytes=budget.estimate_run_bytes(
            st32, grid5, mesh=(4, 1, 1), fuse=4, fuse_kind="stream",
            shards_per_device=4)[0])
        for f in got:
            for blk in f:
                if not bool(torch.isfinite(blk).all()):
                    fail("config 5 float32: non-finite values")
        c5["float32"] = r
        del got
    torch.cuda.empty_cache()
    # BASELINE config 3's decomposition in bfloat16: heat3d 1024^3 --mesh
    # 2,2 --compute pallas (K4 on four shards of the card), its measured
    # peak beside --mem-check's estimate, which must not fall below it
    st16 = make_stencil("heat3d", dtype=BF16)
    flags3 = ("--mesh", "2,2", "--compute", "pallas", *dt16,
              "--mem-check", "error")
    lines.clear()
    (got, r), peak = measured(lambda: run_cli("heat3d", BIG, 16, *flags3))
    est, parts = budget.estimate_run_bytes(
        st16, BIG, mesh=(2, 2), compute="pallas", shards_per_device=4)
    if r["launches"] != {zchunk_key("heat3d", BF16): 64}:
        fail(f"config 3 bf16: launches {r['launches']}")
    if peak > est:
        fail(f"config 3 bf16: peak {peak} B above the estimate {est} B")
    r.update(peak_bytes=peak, estimate_bytes=est,
             budget_log=[ln for ln in lines
                         if ln.startswith("memory budget")][-1],
             budget_parts=[[lb, b] for lb, b in parts])
    c5["config3_bf16_compute_fn"] = r
    del got
    torch.cuda.empty_cache()
    emit({"phase": "config5", "ok": True, "seconds": took(),
          "card": smi, "hbm_bytes": budget.device_hbm_bytes(dev),
          "note": "4 of config 5's 64 shards on one card (virtual "
                  "devices); peak_bytes: torch.cuda.max_memory_allocated "
                  "of the run above what was held before it",
          **c5})

    # ---- 5d. decomposition across processes -------------------------------
    mp_out, nccl_note, _ = multiprocess_phase(counted, lines, main_launches,
                                              scratch)
    emit({"phase": "multiprocess", "ok": True, "seconds": took(),
          "card": smi, "runs": len(mp_out), "nccl": nccl_note,
          "note": "processes that share one card through gloo and pinned "
                  "host buffers: the cost of the process boundary on one "
                  "card, not scaling; exchange_ms_per_step_call: host "
                  "seconds inside the transport (staging copies, posting, "
                  "waiting; not the wait for earlier device work) over the "
                  "step function's calls, the slowest process"})

    # ---- 5e. the pipelined exchange, the sharded checkpoint ----------------
    p5e = pipeline_checkpoint_phase(counted, lines, main_launches, scratch)
    emit({"phase": "pipeline_checkpoint", "ok": True, "seconds": took(),
          "card": smi, "pipeline_runs": len(p5e["pipeline"]),
          "pipeline_multiprocess_runs": len(p5e["pipeline_multiprocess"]),
          "note": "one process: 4 shards on one card (virtual devices); "
                  "across processes: 4 processes sharing the card through "
                  "gloo and pinned host buffers; checkpoint seconds and "
                  "bytes: each process's own blocks, from its log lines"})

    # ---- 5f. the ring across processes ------------------------------------
    p5f = peer_ring_phase(counted, lines, main_launches, scratch)
    emit({"phase": "peer_ring", "ok": True, "seconds": took(),
          "card": smi, "runs": len(p5f["runs"]), "nccl": p5f["nccl"],
          "note": "processes that share one card: the peer ring's slabs "
                  "never leave it (ring_send stores into the peers' "
                  "CUDA IPC-mapped receive slots); the gloo-host twin "
                  "stages them through pinned host buffers; peak: the "
                  "processes' PyTorch peaks plus their ring regions"})

    # ---- 5g. the default --compute auto ------------------------------------
    p5g = auto_dispatch_phase(counted, lines, main_launches, scratch)
    emit({"phase": "auto_dispatch", "ok": True, "seconds": took(),
          "card": smi, "runs": len(p5g["runs"]),
          "note": "each BASELINE command and one 512^3 run per 3D family "
                  "under the default --compute auto, on the path the "
                  "dispatch tables promise (launch counters), bit-equal to "
                  "its explicit-flag run; ms/step beside the plain run"})

    # ---- 5h. the ensemble axis ---------------------------------------------
    p5h = ensemble_phase(counted, lines, main_launches, scratch)
    errs.update(p5h["errs"])
    emit({"phase": "ensemble", "ok": True, "seconds": took(),
          "card": smi, "kernels_checked": len(p5h["checked"]),
          "runs": len(p5h["runs"]),
          "note": "each batched kernel (one launch for a block's members) "
                  "bit-equal to its members' own launches and to its plain "
                  "version; each run's members 0 and N-1 bit-equal to the "
                  "unbatched run of their init; ms_per_step of the batch "
                  "beside N times a member's (n_times_member_ms), each the "
                  "median of CUDA-event chunks after a warm-up chunk "
                  "(cli_ms_per_step: the CLI run's own host clock); "
                  "peak_bytes: torch.cuda.max_memory_allocated above what "
                  "was held, beside --mem-check's estimate"})

    # ---- 5i. device groups ---------------------------------------------------
    p5i = groups_phase(counted, lines, main_launches, scratch)
    emit({"phase": "groups", "ok": True, "seconds": took(),
          "card": smi, "runs": len(p5i["runs"]),
          "launches": p5i["launches"],
          "note": "groups on one card run in turn (virtual devices): "
                  "decomposition overhead, not scaling; ms_per_round and "
                  "exchange_ms: medians of CUDA-event chunks after a "
                  "warm-up chunk; peak_bytes: torch.cuda."
                  "max_memory_allocated above what was held, beside the "
                  "coupled --mem-check estimate (the groups summed)"})

    # ---- 5j. the observability layer ----------------------------------------
    p5j = obs_phase(counted, lines, main_launches, scratch)
    emit({"phase": "obs", "ok": True, "seconds": took(), "card": smi,
          "runs": sorted(p5j["runs"]), "launches": p5j["launches"],
          "note": "config 3 on 4 virtual devices (one card: not scaling); "
                  "ms_per_step_off / _on: the step alone and with the "
                  "recorder's synchronize and record a call, CUDA events "
                  "over 10 calls, alternated; health_ms / audit_ms: one "
                  "check / pass by CUDA events; peak_bytes: the "
                  "recorder's run peak (boundaries included) above what "
                  "was held, beside --mem-check's estimate"})

    # ---- 5k. the live console and the campaign ledger ------------------------
    p5k = serve_phase(counted, lines, main_launches, scratch)
    emit({"phase": "serve", "ok": True, "seconds": took(), "card": smi,
          "runs": sorted(p5k["runs"]), "launches": p5k["launches"],
          "note": "config 3 on 4 virtual devices (one card: not scaling); "
                  "ms_per_step_telemetry / _served: the step with the "
                  "recorder's synchronize and record a call into a live "
                  "log, alone and with the console polling it and a "
                  "scraper every 0.25 s, CUDA events over 50 calls, "
                  "alternated; metrics_ms: each /metrics scrape's "
                  "seconds on the host clock"})

    # ---- 5l. the cost model, the launch checks, --supervise -----------------
    p5l = costmodel_phase(counted, lines, main_launches, scratch, p5k["runs"])
    emit({"phase": "costmodel", "ok": True, "seconds": took(), "card": smi,
          "runs": sorted(p5l["runs"]), "checks": sorted(p5l["checks"]),
          "launches": p5l["launches"],
          "config3_k10_ms_per_step": p5l["config3_k10_ms_per_step"],
          "note": "config 3 on 4 virtual devices (one card: not scaling); "
                  "gap: the console's obs_roofline_gap_ratio, steady p50 "
                  "ms/step (host clock a 16-step chunk, its synchronize "
                  "included) over the roofline's overlapped ms/step; "
                  "config3_k10_ms_per_step beside phase 5k's CUDA-event "
                  "ms/step of the same command; --supervise on config 3's "
                  "K10 command at 512^3"})

    # ---- 6. timing at the main path's shapes --------------------------------
    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def device_ms(fn, reps=20):
        """fn's device time a call: the summed device time of the kernels,
        copies and memsets it issues, from torch.profiler (host time
        left out; the ring's small sites are host-bound)."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.device_time_total for e in prof.key_averages()) \
            / reps / 1e3

    def bound(n_bytes, n_flops):
        b, f = n_bytes / bw * 1e3, n_flops / flops32 * 1e3
        return (b, "bytes") if b >= f else (f, "operations")

    def main_stencil(name, dtype=None):
        """The stencil with the parameters its main-path runs take."""
        kw = {"dtype": dtype} if dtype else {}
        return make_stencil(name, **STENCIL_PARAMS.get(name, {}), **kw)

    def stencil_weight(name, st):
        """(weight, pad): the update as one convolution's weight."""
        from mpi_cuda_process_tpu_torch.ops import heat

        if name == "advect3d":
            # upwind: 1 - sum |c| at the centre, |c_d| at the upstream tap
            w = torch.zeros(1, 1, 3, 3, 3)
            centre = 1.0
            for d, c in enumerate(st.params["courant"]):
                if c == 0.0:
                    continue
                off = [1, 1, 1]
                off[d] += -1 if c > 0 else 1
                w[(0, 0) + tuple(off)] = abs(c)
                centre -= abs(c)
            w[0, 0, 1, 1, 1] = centre
            return w.to(dev), 1

        if name == "heat3d4th":
            a = st.params["alpha"]
            w = torch.zeros(1, 1, 5, 5, 5)
            for d in range(3):
                for s in (-2, -1, 1, 2):
                    off = [2, 2, 2]
                    off[d] += s
                    w[(0, 0) + tuple(off)] = a * heat.W4TH[abs(s)]
            w[0, 0, 2, 2, 2] = 1 + a * heat.w4th_center(3)
            return w.to(dev), 2
        faces = ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                 (1, 1, 2))
        if name == "wave3d":
            c = st.params["c2dt2"]
            w = torch.zeros(1, 2, 3, 3, 3)
            w[0, 0, 1, 1, 1] = 2 - 6 * c
            for off in faces:
                w[(0, 0) + off] = c
            w[0, 1, 1, 1, 1] = -1
            return w.to(dev), 1
        if name == "heat3d":
            a = st.params["alpha"]
            w = torch.zeros(1, 1, 3, 3, 3)
            for off in faces:
                w[(0, 0) + off] = a
            w[0, 0, 1, 1, 1] = 1 - 6 * a
            return w.to(dev), 1
        a = st.params["alpha"]  # heat3d27: faces / edges / corners
        w = torch.empty(1, 1, 3, 3, 3)
        for i in range(27):
            z, y, x_ = i // 9 - 1, i // 3 % 3 - 1, i % 3 - 1
            nz = (z != 0) + (y != 0) + (x_ != 0)
            w[0, 0, z + 1, y + 1, x_ + 1] = a * (
                heat.W27_CENTER, heat.W27_FACE, heat.W27_EDGE,
                heat.W27_CORNER)[nz]
        w[0, 0, 1, 1, 1] += 1
        return w.to(dev), 1

    def library_call(name, st, fields, shape, atol=1e-4):
        """One F.conv3d computing the one-step update on the interior
        (zero padding in place of the frame pin), in the fields' dtype,
        checked against the plain step's interior within ``atol``, as a
        zero-argument callable."""
        w, pad = stencil_weight(name, st)
        w = w.to(fields[0].dtype)
        x = torch.stack(fields).reshape(1, len(fields), *shape)

        def call():
            return F.conv3d(x, w, padding=pad)

        inner = (slice(st.halo, -st.halo),) * 3
        got = call()[0, 0][inner]
        ref = driver.make_step(st, shape)(fields)[0][inner]
        err = float((got.float() - ref.float()).abs().max())
        if not err <= atol:
            fail(f"F.conv3d yardstick for {name} disagrees with the plain "
                 f"step: max|d| {err:.3e}")
        return call

    def padded_library_call(name, st, ins, atol=1e-4):
        """One F.conv3d with padding=0 on the padded block: the compute_fn's
        own function (wave3d: u_prev zero-padded as a second channel), in
        the block's dtype, checked against the plain update within
        ``atol``."""
        w, _ = stencil_weight(name, st)
        w = w.to(ins[0].dtype)
        p = ins[0]
        if name == "wave3d":
            x = torch.stack([p, F.pad(ins[1], (1,) * 6)])[None]
        else:
            x = p[None, None]

        def call():
            return F.conv3d(x, w, padding=0)

        err = float((call()[0, 0].float() - st.update(ins)[0].float())
                    .abs().max())
        if not err <= atol:
            fail(f"padded F.conv3d yardstick for {name} disagrees with the "
                 f"plain update: max|d| {err:.3e}")
        return call

    kernels_out = []

    # kernel wrapper -> (K number, row of PERF.md's table of TPU kernels)
    rows = {"raw_step_heat": ("K1", 1), "raw_step_wave": ("K2", 2),
            "fused_step": ("K3", 5), "fused_step_padded": ("K3", 5),
            "zchunk_heat": ("K4", 12), "zchunk_wave": ("K5", 13),
            "fused_zslab": ("K6", 8), "whole2d": ("K7", 14),
            "fused_yzslab": ("K9", 9), "fused_shell": ("K3", 7),
            "fullgrid_step": ("K8", 15), "fullgrid_padded": ("K8", 15),
            "stream_step": ("K10", 16), "stream_zslab": ("K10", 17),
            "stream_yzslab": ("K10", 18),
            "raw_step_grayscott": ("raw_step_grayscott", 4),
            "ring_exchange": ("ring_exchange", 19),
            "ring_send": ("ring_send", 19), "ring_drain": ("ring_drain", 19)}
    # the table row of a (wrapper, stencil) whose TPU body is its own row:
    # advection's raw-step taps (row 3) and the three families' micro-steps
    # (row 6: _micro_advect, _micro_grayscott, _micro_sor)
    row_of = {("raw_step_heat", "advect3d"): 3,
              ("fused_step", "advect3d"): 6, ("fused_step", "grayscott3d"): 6,
              ("fused_step", "sor3d"): 6,
              ("fused_step_padded", "advect3d"): 6,
              ("fused_step_padded", "grayscott3d"): 6,
              ("fused_step_padded", "sor3d"): 6}

    def record(entry, wrapper, name, src, replaces, ms, plain_ms, moved,
               flops, library_ms, k, shape, per_step, dtype=None):
        """One kernel's line; ``dtype`` (bfloat16) names its kind, whose
        launches are counted apart ("wrapper[name,bfloat16]")."""
        b_ms, b_by = bound(moved, flops)
        key = f"{wrapper}[{name},{dtype}]" if dtype else f"{wrapper}[{name}]"
        kernels_out.append({
            "name": entry, "kernel": rows[wrapper][0],
            "table_row": row_of.get((wrapper, name), rows[wrapper][1]),
            "route": "cuda", "dtype": dtype or "float32",
            "source": f"{PKG}/ops/cuda/csrc/{src}", "replaces": replaces,
            "launches": main_launches.get(key, 0),
            "groups_launches": p5i["launches"].get(key, 0),
            "obs_launches": p5j["launches"].get(key, 0),
            "serve_launches": p5k["launches"].get(key, 0),
            "costmodel_launches": p5l["launches"].get(key, 0),
            "max_abs_err": errs[entry], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "steps_per_launch": k, "shape": list(shape),
            "launches_per_step": per_step})

    def split2d(st, ins_shape, make):
        """One --compute pallas step of ``st`` at 16384^2 split by CUDA
        events into pad, K7 and re-pin (driver.make_step's pieces)."""
        f = make(GRID2D)
        bc = st.bc_value[0]
        comp = kernels.make_pallas_compute(st, device=dev)
        padded = driver.pad(f, 1, False, bc)
        new = comp((padded,))[0]
        mask = driver.frame_mask(GRID2D, GRID2D, (0, 0), 1, dev)
        step = driver.make_step(st, GRID2D, compute_fn=comp)
        row = {"stencil": st.name, "grid": list(GRID2D),
               "dtype": str(st.dtype).replace("torch.", ""),
               "pad_ms": time_ms(lambda: driver.pad(f, 1, False, bc), 10),
               "kernel_ms": time_ms(lambda: comp((padded,)), 10),
               "repin_ms": time_ms(lambda: torch.where(mask, f, new), 10),
               "step_ms": time_ms(lambda: step((f,)), 10)}
        del f, padded, new, mask
        return row

    cells = math.prod(MAIN)
    nbytes = 4 * cells
    for entry, wrapper, name, k, replaces in (
            ("raw_step_heat<heat3d>", "raw_step_heat", "heat3d", 1,
             "rawstep.py:164"),
            ("raw_step_heat<heat3d27>", "raw_step_heat", "heat3d27", 1,
             "rawstep.py:164"),
            ("raw_step_heat<heat3d4th>", "raw_step_heat", "heat3d4th", 1,
             "rawstep.py:164"),
            ("raw_step_wave", "raw_step_wave", "wave3d", 1, "rawstep.py:172"),
            ("fused_step<heat3d>", "fused_step", "heat3d", 4,
             "fused.py:280"),
            ("fused_step<heat3d27>", "fused_step", "heat3d27", 4,
             "fused.py:280"),
            ("fused_step<heat3d4th>", "fused_step", "heat3d4th", 2,
             "fused.py:280"),
            ("fused_step<wave3d>", "fused_step", "wave3d", 4,
             "fused.py:280"),
            ("stream_step<heat3d>", "stream_step", "heat3d", 4,
             "streamfused.py:377"),
            ("stream_step<heat3d27>", "stream_step", "heat3d27", 4,
             "streamfused.py:377"),
            ("stream_step<heat3d4th>", "stream_step", "heat3d4th", 2,
             "streamfused.py:377"),
            ("stream_step<wave3d>", "stream_step", "wave3d", 4,
             "streamfused.py:377"),
            ("raw_step_heat<advect3d>", "raw_step_heat", "advect3d", 1,
             "rawstep.py:182"),
            ("raw_step_grayscott", "raw_step_grayscott", "grayscott3d", 1,
             "rawstep.py:200"),
            ("fused_step<advect3d>", "fused_step", "advect3d", 4,
             "fused.py:184"),
            ("fused_step<grayscott3d>", "fused_step", "grayscott3d", 4,
             "fused.py:203"),
            ("stream_step<advect3d>", "stream_step", "advect3d", 4,
             "streamfused.py:377"),
            ("stream_step<grayscott3d>", "stream_step", "grayscott3d", 4,
             "streamfused.py:377")):
        st = main_stencil(name)
        fields = tuple(rand(MAIN) for _ in range(st.num_fields))
        if wrapper == "fused_step":
            kern = fused.make_fused_step(st, MAIN, k, device=dev)
            src = "fused.cu"
            moved = 2 * st.num_fields * nbytes
        elif wrapper == "stream_step":
            kern = streamfused.make_stream_fused_step(st, MAIN, k, device=dev)
            src = "streamfused.cu"
            moved = 2 * st.num_fields * nbytes
        else:
            kern = rawstep.make_raw_step(st, MAIN, device=dev)
            src = "rawstep.cu"
            # every field read once; wave writes u only, Gray-Scott both
            moved = (st.num_fields + (2 if name == "grayscott3d" else 1)
                     ) * nbytes
        plain = driver.make_step(st, MAIN)

        def run_plain(fields=fields, plain=plain, k=k):
            fs = fields
            for _ in range(k):
                fs = plain(fs)
            return fs

        ms = time_ms(lambda: kern(fields), 20)
        plain_ms = time_ms(run_plain, 3)
        library_ms = None
        if wrapper in ("raw_step_heat", "raw_step_wave"):
            library_ms = time_ms(library_call(name, st, fields, MAIN), 20)
        record(entry, wrapper, name, src, TPU + replaces, ms, plain_ms, moved,
               FLOPS_PER_CELL[name] * k * cells, library_ms, k, MAIN,
               1.0 / k)
        del fields

    # the sharded kernels, one shard of the sharded main path's run
    split = []
    for name, grid, _iters, k, overlapped in MESH_RUNS:
        st = make_stencil(name)
        h = st.halo
        nf = st.num_fields
        mesh = virtual_mesh((2, 2))
        local = (grid[0] // 2, grid[1] // 2, grid[2])
        lcells = math.prod(local)
        # K4 / K5 on one shard's padded block
        padded = tuple(s + 2 * h for s in local)
        ins = (rand(padded),) + ((rand(local),) if nf == 2 else ())
        comp = kernels.make_pallas_compute(st, device=dev)
        ms = time_ms(lambda: comp(ins), 20)
        plain_ms = time_ms(lambda: st.update(ins), 3)
        library_ms = time_ms(padded_library_call(name, st, ins), 10)
        moved = 4 * (math.prod(padded) + lcells * nf)
        entry = "zchunk_wave" if name == "wave3d" else f"zchunk_heat<{name}>"
        wrapper = "zchunk_wave" if name == "wave3d" else "zchunk_heat"
        record(entry, wrapper, name, "zchunk.cu",
               TPU + ("kernels.py:138" if name == "wave3d"
                      else "kernels.py:133"),
               ms, plain_ms, moved, FLOPS_PER_CELL[name] * lcells,
               library_ms, 1, local, 4.0)
        del ins
        # K3 sharded mode on one shard's z/y-padded block
        m = k * h
        pshape = (local[0] + 2 * m, local[1] + 2 * m, local[2])
        ins = tuple(rand(pshape) for _ in range(nf))
        kern = lambda: fused.fused_step_padded(ins, st, k, grid, (0, 0))
        plain = lambda: fused._plain_window_steps(
            ins, st, k, (-m, -m, 0), grid, False, (2,))
        ms = time_ms(kern, 10)
        plain_ms = time_ms(plain, 2)
        record(f"fused_step_padded<{name}>", "fused_step_padded", name,
               "fused.cu", TPU + "fused.py:280", ms, plain_ms,
               4 * nf * (math.prod(pshape) + lcells),
               FLOPS_PER_CELL[name] * k * lcells, None, k, local, 4.0 / k)
        del ins
        # K9 on one shard of --mesh 2,2 --fuse-kind padfree: the core, its
        # z and y slabs and its corners
        Lz, Ly, X = local

        def pieces(shape):
            return tuple(rand(shape) for _ in range(nf))

        core = pieces(local)
        zlo, zhi = pieces((m, Ly, X)), pieces((m, Ly, X))
        ylo, yhi = pieces((Lz, m, X)), pieces((Lz, m, X))
        corners = [pieces((m, m, X)) for _ in range(4)]
        yz_args = (core, zlo, zhi, ylo, yhi, corners, st, k, grid, (0, 0))
        ms = time_ms(lambda: fused.fused_yzslab(*yz_args), 10)
        plain_ms = time_ms(lambda: fused.plain_yzslab(*yz_args), 2)
        yz_bytes = 4 * nf * (2 * lcells + 2 * m * X * (Ly + Lz + 2 * m))
        record(f"fused_yzslab<{name}>", "fused_yzslab", name, "fused.cu",
               TPU + "fused.py:562", ms, plain_ms, yz_bytes,
               FLOPS_PER_CELL[name] * k * lcells, None, k, local, 4.0 / k)
        # K10 on the same operands (the plain version is the same function)
        ms = time_ms(lambda: streamfused.stream_yzslab(*yz_args), 10)
        record(f"stream_yzslab<{name}>", "stream_yzslab", name,
               "streamfused.cu", TPU + "streamfused.py:399", ms, plain_ms,
               yz_bytes, FLOPS_PER_CELL[name] * k * lcells, None, k, local,
               4.0 / k)
        del core, zlo, zhi, ylo, yhi, corners, yz_args
        if "yzslab_overlap" in overlapped:
            # one hi z shell of a 2x2 shard: a 4m-deep strip in, 2m out
            shells = fused.build_overlap_shell_calls(st, local, grid, k,
                                                     (0, 1), device=dev)
            strips = pieces((4 * m, Ly + 2 * m, X))
            org = (Lz - 2 * m, 0)
            ms = time_ms(lambda: shells[0](org, *strips), 20)
            plain_ms = time_ms(
                lambda: fused.plain_step_padded(strips, st, k, grid, org), 3)
            scells = 2 * m * Ly * X
            record(f"fused_shell<{name}>", "fused_shell", name, "fused.cu",
                   TPU + "fused.py:1284", ms, plain_ms,
                   4 * nf * (math.prod(strips[0].shape) + scells),
                   FLOPS_PER_CELL[name] * k * scells, None, k,
                   (2 * m, Ly, X), 16.0 / k)
            del strips
        if grid == BIG:
            # K6 on one z-only shard of --mesh 4
            zl = (grid[0] // 4, grid[1], grid[2])
            zcells = math.prod(zl)
            core = tuple(rand(zl) for _ in range(nf))
            lo = tuple(rand((m, zl[1], zl[2])) for _ in range(nf))
            hi = tuple(rand((m, zl[1], zl[2])) for _ in range(nf))
            kern = lambda: fused.fused_zslab(core, lo, hi, st, k, grid[0], 0)

            def plain(core=core, lo=lo, hi=hi):
                win = tuple(torch.cat(t) for t in zip(lo, core, hi))
                return fused._plain_window_steps(win, st, k, (-m, 0, 0),
                                                 grid, False, (1, 2))

            ms = time_ms(kern, 10)
            plain_ms = time_ms(plain, 2)
            z_bytes = 4 * nf * (2 * zcells + 2 * m * zl[1] * zl[2])
            record(f"fused_zslab<{name}>", "fused_zslab", name, "fused.cu",
                   TPU + "fused.py:432", ms, plain_ms, z_bytes,
                   FLOPS_PER_CELL[name] * k * zcells, None, k, zl, 4.0 / k)
            ms = time_ms(lambda: streamfused.stream_zslab(
                core, lo, hi, st, k, grid[0], 0), 10)
            record(f"stream_zslab<{name}>", "stream_zslab", name,
                   "streamfused.cu", TPU + "streamfused.py:386", ms,
                   plain_ms, z_bytes, FLOPS_PER_CELL[name] * k * zcells,
                   None, k, zl, 4.0 / k)
            del core, lo, hi
        if grid == BIG:
            # one sharded step on 2x2, split into exchange/pad, kernel and
            # re-pin by CUDA events (the pieces make_sharded_step runs)
            fields = stepper.shard_fields(
                tuple(rand(grid) for _ in range(nf)), mesh, 3)
            step = stepper.make_sharded_step(st, mesh, grid, compute_fn=comp)
            ex = lambda: [halo.exchange_and_pad(f, mesh, fh, bc)
                          for f, bc, fh in zip(fields, st.bc_value,
                                               st.field_halos)]
            pads = ex()
            new = [comp(tuple(p[i] for p in pads)) for i in range(4)]
            masks = [driver.frame_mask(
                local, grid, stepper.shard_offsets(c, local), h, dev)
                for c in mesh.coords()]
            row = {"stencil": name, "grid": list(grid), "mesh": [2, 2],
                   "exchange_pad_ms": time_ms(ex, 5),
                   "kernel_ms": time_ms(
                       lambda: [comp(tuple(p[i] for p in pads))
                                for i in range(4)], 5),
                   "repin_ms": time_ms(
                       lambda: [torch.where(masks[i], fields[0][i],
                                            new[i][0]) for i in range(4)],
                       5),
                   "step_ms": time_ms(lambda: step(fields), 5)}
            fstep = stepper.make_sharded_fused_step(st, mesh, grid, k,
                                                    device=dev)
            row["fused_exchange_pad_ms"] = time_ms(
                lambda: [halo.exchange_and_pad(f, mesh, k * h, bc,
                                               axes=(0, 1))
                         for f, bc in zip(fields, st.bc_value)], 3)
            row["fused_step_ms"] = time_ms(lambda: fstep(fields), 3)
            row["exchange_slabs_2axis_ms"] = time_ms(
                lambda: [halo.exchange_slabs_2axis(f, mesh, k * h, bc)
                         for f, bc in zip(fields, st.bc_value)], 3)
            for label, kw in (("fused_overlap", {"overlap": True}),
                              ("yzslab", {"kind": "padfree"}),
                              ("yzslab_overlap", {"kind": "padfree",
                                                  "overlap": True}),
                              ("stream_yz", {"kind": "stream"}),
                              ("stream_yz_overlap", {"kind": "stream",
                                                     "overlap": True})):
                fstep = stepper.make_sharded_fused_step(st, mesh, grid, k,
                                                        device=dev, **kw)
                row[f"{label}_step_ms"] = time_ms(lambda: fstep(fields), 3)
            split.append(row)
            del fields, pads, new, masks
        torch.cuda.empty_cache()

    # advection and Gray-Scott: K3's sharded mode and K10 on one shard of
    # the 512^3 --mesh 2,2 run, and one hi z shell of it
    for name, grid, _iters, k, _overlapped in NEW_MESH_RUNS:
        st = main_stencil(name)
        nf, m = st.num_fields, k * st.halo
        local = (grid[0] // 2, grid[1] // 2, grid[2])
        lcells = math.prod(local)
        micro = TPU + ("fused.py:184" if name == "advect3d"
                       else "fused.py:203")
        pshape = (local[0] + 2 * m, local[1] + 2 * m, local[2])
        ins = tuple(rand(pshape) for _ in range(nf))
        ms = time_ms(lambda: fused.fused_step_padded(ins, st, k, grid,
                                                     (0, 0)), 10)
        plain_ms = time_ms(lambda: fused._plain_window_steps(
            ins, st, k, (-m, -m, 0), grid, False, (2,)), 2)
        record(f"fused_step_padded<{name}>", "fused_step_padded", name,
               "fused.cu", micro, ms, plain_ms,
               4 * nf * (math.prod(pshape) + lcells),
               FLOPS_PER_CELL[name] * k * lcells, None, k, local, 4.0 / k)
        del ins
        Lz, Ly, X = local
        core = tuple(rand(local) for _ in range(nf))
        zlo, zhi = (tuple(rand((m, Ly, X)) for _ in range(nf))
                    for _ in range(2))
        ylo, yhi = (tuple(rand((Lz, m, X)) for _ in range(nf))
                    for _ in range(2))
        corners = [tuple(rand((m, m, X)) for _ in range(nf))
                   for _ in range(4)]
        yz_args = (core, zlo, zhi, ylo, yhi, corners, st, k, grid, (0, 0))
        ms = time_ms(lambda: streamfused.stream_yzslab(*yz_args), 10)
        plain_ms = time_ms(lambda: fused.plain_yzslab(*yz_args), 2)
        record(f"stream_yzslab<{name}>", "stream_yzslab", name,
               "streamfused.cu", TPU + "streamfused.py:399", ms, plain_ms,
               4 * nf * (2 * lcells + 2 * m * X * (Ly + Lz + 2 * m)),
               FLOPS_PER_CELL[name] * k * lcells, None, k, local, 4.0 / k)
        del core, zlo, zhi, ylo, yhi, corners, yz_args
        # K10 on one z-only shard of the 512^3 --mesh 4 run (row 17)
        zl = (grid[0] // 4, grid[1], grid[2])
        zcells = math.prod(zl)
        core = tuple(rand(zl) for _ in range(nf))
        lo = tuple(rand((m,) + zl[1:]) for _ in range(nf))
        hi = tuple(rand((m,) + zl[1:]) for _ in range(nf))
        ms = time_ms(lambda: streamfused.stream_zslab(core, lo, hi, st, k,
                                                      grid[0], 0), 10)
        plain_ms = time_ms(lambda: fused.plain_zslab(core, lo, hi, st, k,
                                                     grid[0], 0), 2)
        record(f"stream_zslab<{name}>", "stream_zslab", name,
               "streamfused.cu", TPU + "streamfused.py:386", ms, plain_ms,
               4 * nf * (2 * zcells + 2 * m * zl[1] * zl[2]),
               FLOPS_PER_CELL[name] * k * zcells, None, k, zl, 4.0 / k)
        del core, lo, hi
        shells = fused.build_overlap_shell_calls(st, local, grid, k, (0, 1),
                                                 device=dev)
        strips = tuple(rand((4 * m, local[1] + 2 * m, local[2]))
                       for _ in range(nf))
        org = (local[0] - 2 * m, 0)
        ms = time_ms(lambda: shells[0](org, *strips), 20)
        plain_ms = time_ms(
            lambda: fused.plain_step_padded(strips, st, k, grid, org), 3)
        scells = 2 * m * local[1] * local[2]
        record(f"fused_shell<{name}>", "fused_shell", name, "fused.cu",
               TPU + "fused.py:1284", ms, plain_ms,
               4 * nf * (math.prod(strips[0].shape) + scells),
               FLOPS_PER_CELL[name] * k * scells, None, k,
               (2 * m, local[1], local[2]), 16.0 / k)
        del strips
        torch.cuda.empty_cache()

    # 2D kernels at 16384^2 (K8 sharded: one shard of --mesh 4)
    H, W = GRID2D
    cells2d = H * W
    for name in ("heat2d", "life"):
        st = make_stencil(name)
        ins = rand2d(name, (H + 2, W + 2))
        comp = kernels.make_pallas_compute(st, device=dev)
        ms = time_ms(lambda: comp(ins), 20)
        plain_ms = time_ms(lambda: st.update(ins), 3)
        library_ms = None
        if name == "heat2d":
            a = st.params["alpha"]
            w = torch.tensor([[0, a, 0], [a, 1 - 4 * a, a], [0, a, 0]],
                             dtype=torch.float32, device=dev)[None, None]
            x = ins[0][None, None]

            def conv(x=x, w=w):
                return F.conv2d(x, w, padding=0)

            err = float((conv()[0, 0] - st.update(ins)[0]).abs().max())
            if not err <= 1e-4:
                fail(f"F.conv2d yardstick for heat2d disagrees with the "
                     f"plain update: max|d| {err:.3e}")
            library_ms = time_ms(conv, 10)
        record(f"whole2d<{name}>", "whole2d", name, "whole2d.cu",
               TPU + ("kernels.py:260" if name == "life"
                      else "kernels.py:254"),
               ms, plain_ms, 4 * ((H + 2) * (W + 2) + cells2d),
               FLOPS_PER_CELL[name] * cells2d, library_ms, 1, GRID2D, 1.0)
        del ins
        if name == "heat2d":
            split.append(split2d(st, GRID2D, lambda s_: rand(s_)))
    k = FUSE2D
    for name in ("life", "heat2d", "wave2d", "advect2d", "grayscott2d",
                 "sor2d"):
        st = main_stencil(name)
        nf = st.num_fields
        m = k_step_margin(st, k)
        fields = rand2d(name, GRID2D)
        kern = fullgrid.make_fullgrid_step(st, GRID2D, k, device=dev)
        plain = driver.make_step(st, GRID2D)

        def run_plain(fields=fields, plain=plain):
            fs = fields
            for _ in range(k):
                fs = plain(fs)
            return fs

        ms = time_ms(lambda: kern(fields), 10)
        plain_ms = time_ms(run_plain, 2)
        record(f"fullgrid_step<{name}>", "fullgrid_step", name, "fullgrid.cu",
               TPU + ("fullgrid.py:56" if name == "life"
                      else "fullgrid.py:120"),
               ms, plain_ms, 2 * nf * 4 * cells2d,
               FLOPS_PER_CELL[name] * k * cells2d, None, k, GRID2D, 1.0 / k)
        del fields
        if name in ("wave2d", "advect2d"):
            continue  # the sharded main path runs life, heat2d, grayscott2d
            # and sor2d
        local = (H // 4, W)
        pshape = (H // 4 + 2 * m, W)
        ins = rand2d(name, pshape)
        kern = lambda: fullgrid.fullgrid_padded(ins, st, k, H, 0)
        plain = lambda: fused._plain_window_steps(ins, st, k, (-m, 0),
                                                  GRID2D, False, (1,))
        ms = time_ms(kern, 10)
        plain_ms = time_ms(plain, 2)
        record(f"fullgrid_padded<{name}>", "fullgrid_padded", name,
               "fullgrid.cu", TPU + "fullgrid.py:120", ms, plain_ms,
               4 * nf * (math.prod(pshape) + math.prod(local)),
               FLOPS_PER_CELL[name] * k * math.prod(local), None, k, local,
               4.0 / k)
        del ins
        torch.cuda.empty_cache()

    # red-black SOR: K3 and K10 at 512^3 (the unsharded main path's shape),
    # and one shard of the 1024^3 runs: K3's sharded mode, K9 and K10 on a
    # 2x2 shard, one hi z shell of it, K6 and K10 on a --mesh 4 shard
    for name, grid, _iters, k, _overlapped in SOR_MESH_RUNS:
        st = make_stencil(name)
        m = k_step_margin(st, k)
        micro = TPU + "fused.py:224"
        flops = FLOPS_PER_CELL[name] * k
        fields = (rand(MAIN),)
        plain_ms = time_ms(lambda: fused.plain_steps(fields, st, k), 2)
        for wrapper, kern, src, replaces in (
                ("fused_step", fused.make_fused_step(st, MAIN, k, device=dev),
                 "fused.cu", micro),
                ("stream_step", streamfused.make_stream_fused_step(
                    st, MAIN, k, device=dev), "streamfused.cu",
                 TPU + "streamfused.py:377")):
            ms = time_ms(lambda: kern(fields), 10)
            record(f"{wrapper}<{name}>", wrapper, name, src, replaces, ms,
                   plain_ms, 2 * nbytes, flops * cells, None, k, MAIN,
                   1.0 / k)
        del fields
        local = (grid[0] // 2, grid[1] // 2, grid[2])
        Lz, Ly, X = local
        lcells = math.prod(local)
        pshape = (Lz + 2 * m, Ly + 2 * m, X)
        ins = (rand(pshape),)
        ms = time_ms(lambda: fused.fused_step_padded(ins, st, k, grid,
                                                     (0, 0)), 10)
        plain_ms = time_ms(lambda: fused.plain_step_padded(ins, st, k, grid,
                                                           (0, 0)), 2)
        record(f"fused_step_padded<{name}>", "fused_step_padded", name,
               "fused.cu", micro, ms, plain_ms,
               4 * (math.prod(pshape) + lcells), flops * lcells, None, k,
               local, 4.0 / k)
        del ins
        core = (rand(local),)
        zlo, zhi = (rand((m, Ly, X)),), (rand((m, Ly, X)),)
        ylo, yhi = (rand((Lz, m, X)),), (rand((Lz, m, X)),)
        corners = [(rand((m, m, X)),) for _ in range(4)]
        yz_args = (core, zlo, zhi, ylo, yhi, corners, st, k, grid, (0, 0))
        plain_ms = time_ms(lambda: fused.plain_yzslab(*yz_args), 2)
        yz_bytes = 4 * (2 * lcells + 2 * m * X * (Ly + Lz + 2 * m))
        for wrapper, fn, src, replaces in (
                ("fused_yzslab", fused.fused_yzslab, "fused.cu",
                 TPU + "fused.py:562"),
                ("stream_yzslab", streamfused.stream_yzslab,
                 "streamfused.cu", TPU + "streamfused.py:399")):
            ms = time_ms(lambda: fn(*yz_args), 10)
            record(f"{wrapper}<{name}>", wrapper, name, src, replaces, ms,
                   plain_ms, yz_bytes, flops * lcells, None, k, local,
                   4.0 / k)
        del core, zlo, zhi, ylo, yhi, corners, yz_args
        shells = fused.build_overlap_shell_calls(st, local, grid, k, (0, 1),
                                                 device=dev)
        strips = (rand((4 * m, Ly + 2 * m, X)),)
        org = (Lz - 2 * m, 0)
        ms = time_ms(lambda: shells[0](org, *strips), 20)
        plain_ms = time_ms(
            lambda: fused.plain_step_padded(strips, st, k, grid, org), 3)
        scells = 2 * m * Ly * X
        record(f"fused_shell<{name}>", "fused_shell", name, "fused.cu",
               TPU + "fused.py:1284", ms, plain_ms,
               4 * (math.prod(strips[0].shape) + scells), flops * scells,
               None, k, (2 * m, Ly, X), 16.0 / k)
        del strips
        zl = (grid[0] // 4, grid[1], grid[2])
        zcells = math.prod(zl)
        core = (rand(zl),)
        lo, hi = (rand((m,) + zl[1:]),), (rand((m,) + zl[1:]),)
        plain_ms = time_ms(lambda: fused.plain_zslab(core, lo, hi, st, k,
                                                     grid[0], 0), 2)
        z_bytes = 4 * (2 * zcells + 2 * m * zl[1] * zl[2])
        for wrapper, fn, src, replaces in (
                ("fused_zslab", fused.fused_zslab, "fused.cu",
                 TPU + "fused.py:432"),
                ("stream_zslab", streamfused.stream_zslab, "streamfused.cu",
                 TPU + "streamfused.py:386")):
            ms = time_ms(lambda: fn(core, lo, hi, st, k, grid[0], 0), 10)
            record(f"{wrapper}<{name}>", wrapper, name, src, replaces, ms,
                   plain_ms, z_bytes, flops * zcells, None, k, zl, 4.0 / k)
        del core, lo, hi
        torch.cuda.empty_cache()

    # the ring exchange at the sharded main path's sites (heat3d 1024^3, 4
    # shards on the card, one launch each): a 2x2 shard's z slab, y slab and
    # corner, a --mesh 4 shard's z slab.  Library: one copy_ per slab, what
    # the in-process exchange does for the same shift.  Bound: each slab
    # read once, each received slab written once.
    per100 = {}  # ring launches per 100 iterations of heat3d's runs
    for r in mesh_results:
        if r["stencil"] == "heat3d" and "rdma" in r["flags"] and \
                "--overlap" not in r["flags"]:
            for key, n in r["launches"].items():
                if key.startswith("ring_exchange"):
                    per100[key] = 100 * n / r["iters"]
    ring_vs_k10 = []
    for mshape, axis, shape in (((2, 2), 0, (4, 512, 1024)),
                                ((2, 2), 1, (512, 4, 1024)),
                                ((2, 2), 1, (4, 4, 1024)),
                                ((4,), 0, (4, 1024, 1024))):
        mesh = virtual_mesh(mshape)
        nxt, prv = ring_of(mesh, axis)
        hi = [rand(shape) for _ in range(4)]
        lo = [rand(shape) for _ in range(4)]
        call, meta = remote.build_ring_exchange_call(shape, torch.float32,
                                                     device=dev)
        ms = time_ms(lambda: call(hi, lo, nxt, prv), 50)
        call.state.check_drained(meta)
        plain_state = remote.RingState(meta, 4, dev)
        plain_ms = time_ms(lambda: remote.plain_ring_exchange(
            hi, lo, nxt, prv, meta, plain_state), 3)
        outs = [torch.empty_like(t) for t in hi + lo]

        def copies(hi=hi, lo=lo, outs=outs, nxt=nxt, prv=prv):
            for i in range(4):
                outs[i].copy_(hi[prv[i]])
                outs[4 + i].copy_(lo[nxt[i]])

        library_ms = time_ms(copies, 50)
        name = "x".join(map(str, shape))
        key = f"ring_exchange[{name}]"
        record(f"ring_exchange<{name}>", "ring_exchange", name, "remote.cu",
               TPU + "remote.py:136", ms, plain_ms,
               2 * 4 * 2 * meta["slab_bytes"], 0, library_ms, 4, shape,
               per100.get(key, 0.0) / 100)
        kernels_out[-1].update(
            mesh=list(mshape), chunks=[meta["chunk_axis"], meta["nchunks"]],
            nslots=meta["nslots"], blocks=call.state.blocks,
            launches_per_100_iterations=per100.get(key),
            device_ms=device_ms(lambda: call(hi, lo, nxt, prv)),
            library_device_ms=device_ms(copies))
        if shape == (4, 512, 1024):
            # --overlap runs the ring on a side stream beside K10's interior
            # (heat3d, one 2x2 shard's operands, once per shard): does the
            # ring launch run beside it, or wait for it?
            st = make_stencil("heat3d")
            Lz, Ly, X = 512, 512, 1024
            core = (rand((Lz, Ly, X)),)
            pieces = [(rand(s_),) for s_ in ((4, Ly, X), (4, Ly, X),
                                             (Lz, 4, X), (Lz, 4, X))]
            corners = [(rand((4, 4, X)),) for _ in range(4)]
            k10_args = (core, *pieces, corners, st, 4, BIG, (0, 0))

            def interior():
                for _ in range(4):
                    streamfused.stream_yzslab(*k10_args)

            side_stream = torch.cuda.Stream()
            with torch.cuda.stream(side_stream):  # warm: first use there
                call(hi, lo, nxt, prv)
            torch.cuda.synchronize()
            k10_ms = time_ms(interior, 3)
            ring_alone = ms
            main_s = torch.cuda.current_stream()
            seen = []
            for _ in range(3):
                t0 = torch.cuda.Event(enable_timing=True)
                ring_end = torch.cuda.Event(enable_timing=True)
                k10_end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0.record(main_s)
                side_stream.wait_stream(main_s)
                interior()
                k10_end.record(main_s)
                with torch.cuda.stream(side_stream):
                    call(hi, lo, nxt, prv)
                    ring_end.record(side_stream)
                main_s.wait_stream(side_stream)
                torch.cuda.synchronize()
                seen.append((t0.elapsed_time(ring_end),
                              t0.elapsed_time(k10_end)))
            call.state.check_drained(meta)
            ring_vs_k10.append({
                "ring_shape": list(shape), "ring_alone_ms": ring_alone,
                "k10_interior_ms": k10_ms,
                "ring_done_after_ms": [a for a, _ in seen],
                "k10_done_after_ms": [b for _, b in seen],
                "note": "ring issued on a side stream just after the four "
                        "K10 interior launches; ring_done_after_ms near "
                        "ring_alone_ms: it ran beside K10; near "
                        "k10_done_after_ms: it waited for K10"})
            del core, pieces, corners, k10_args
        del hi, lo, outs, call
        torch.cuda.empty_cache()
    # the stream kind's sharded step with each exchange, by CUDA events over
    # 10 passes each, in turns (ppermute, rdma, rdma, ppermute): heat3d at
    # 1024^3 and Gray-Scott at 512^3 on 2x2, with and without the shells
    exchange_ab = []
    for name, grid in (("heat3d", BIG), ("grayscott3d", MAIN)):
        st = make_stencil(name)
        mesh = virtual_mesh((2, 2))
        fields = stepper.shard_fields(
            tuple(rand(grid) for _ in range(st.num_fields)), mesh, 3)
        for overlap in (False, True):
            steps = {ex: stepper.make_sharded_fused_step(
                st, mesh, grid, 4, kind="stream", overlap=overlap,
                exchange=ex, device=dev) for ex in ("ppermute", "rdma")}
            turns = [(ex, time_ms(lambda: steps[ex](fields), 10) / 4)
                     for ex in ("ppermute", "rdma", "rdma", "ppermute")]
            exchange_ab.append({
                "stencil": name, "grid": list(grid), "mesh": [2, 2],
                "overlap": overlap, "unit": "ms per step (a pass / 4)",
                "turns": [[ex, v] for ex, v in turns]})
        del fields, steps
        torch.cuda.empty_cache()
    peer_ring_timing(dev, rand, time_ms, record, kernels_out, p5f)
    # bfloat16 kinds at their f32 twins' shapes: K1's four tap sets, K2
    # and raw_step_grayscott at 512^3 (one F.conv3d in bfloat16 beside K1
    # and K2, checked against the plain step at the bf16 tolerance); K10
    # RAW at 512^3, ZSLAB on a --mesh 4 shard and YZSLAB on a 2x2 shard of
    # 1024^3, every family; the ring at the 1024^3 2x2 sites and config
    # 5's z-slab site beside one copy_ per slab.  Bytes at 2 B a cell; the
    # arithmetic is float32 (the flop bound is the float32 rate).
    bf16 = torch.bfloat16

    def rand16(shape):
        return rand(shape).to(bf16)

    raw_row = {"raw_step_heat": "rawstep.py:164",
               "raw_step_wave": "rawstep.py:172",
               "raw_step_grayscott": "rawstep.py:200"}
    for name in ("heat3d", "heat3d27", "heat3d4th", "wave3d", "advect3d",
                 "grayscott3d"):
        st = main_stencil(name, BF16)
        fields = tuple(rand16(MAIN) for _ in range(st.num_fields))
        kern = rawstep.make_raw_step(st, MAIN, device=dev)
        plain = driver.make_step(st, MAIN)
        wrapper = raw_key(name).partition("[")[0]
        ms = time_ms(lambda: kern(fields), 20)
        plain_ms = time_ms(lambda: plain(fields), 3)
        library_ms = None
        if wrapper != "raw_step_grayscott":
            library_ms = time_ms(library_call(
                name, st, fields, MAIN, atol=32 * 2.0 ** -7 * max(
                    float(fields[0].float().abs().max()), 1.0)), 20)
        replaces = ("rawstep.py:182" if name == "advect3d"
                    else raw_row[wrapper])
        moved = (st.num_fields + (2 if name == "grayscott3d" else 1)
                 ) * 2 * cells
        record(f"{wrapper}<{name},{BF16}>", wrapper, name, "rawstep.cu",
               TPU + replaces, ms, plain_ms, moved,
               FLOPS_PER_CELL[name] * cells, library_ms, 1, MAIN, 1.0,
               dtype=BF16)
        del fields
    for name, k in BF16_FAMILIES:
        st = main_stencil(name, BF16)
        nf, m = st.num_fields, k_step_margin(st, k)
        flops = FLOPS_PER_CELL[name] * k
        fields = tuple(rand16(MAIN) for _ in range(nf))
        kern = streamfused.make_stream_fused_step(st, MAIN, k, device=dev)
        ms = time_ms(lambda: kern(fields), 10)
        plain_ms = time_ms(lambda: fused.plain_steps(fields, st, k), 1)
        record(f"stream_step<{name},{BF16}>", "stream_step", name,
               "streamfused.cu", TPU + "streamfused.py:377", ms, plain_ms,
               2 * nf * 2 * cells, flops * cells, None, k, MAIN, 1.0 / k,
               dtype=BF16)
        del fields
        zl = (BIG[0] // 4, BIG[1], BIG[2])
        zcells = math.prod(zl)
        core = tuple(rand16(zl) for _ in range(nf))
        lo = tuple(rand16((m,) + zl[1:]) for _ in range(nf))
        hi = tuple(rand16((m,) + zl[1:]) for _ in range(nf))
        ms = time_ms(lambda: streamfused.stream_zslab(core, lo, hi, st, k,
                                                      BIG[0], 0), 10)
        plain_ms = time_ms(lambda: fused.plain_zslab(core, lo, hi, st, k,
                                                     BIG[0], 0), 1)
        record(f"stream_zslab<{name},{BF16}>", "stream_zslab", name,
               "streamfused.cu", TPU + "streamfused.py:386", ms, plain_ms,
               2 * nf * (2 * zcells + 2 * m * zl[1] * zl[2]),
               flops * zcells, None, k, zl, 4.0 / k, dtype=BF16)
        del core, lo, hi
        Lz, Ly, X = local = (BIG[0] // 2, BIG[1] // 2, BIG[2])
        lcells = math.prod(local)
        yz_args = (tuple(rand16(local) for _ in range(nf)),
                   *(tuple(rand16(s_) for _ in range(nf))
                     for s_ in ((m, Ly, X), (m, Ly, X), (Lz, m, X),
                                (Lz, m, X))),
                   [tuple(rand16((m, m, X)) for _ in range(nf))
                    for _ in range(4)], st, k, BIG, (0, 0))
        ms = time_ms(lambda: streamfused.stream_yzslab(*yz_args), 10)
        plain_ms = time_ms(lambda: fused.plain_yzslab(*yz_args), 1)
        record(f"stream_yzslab<{name},{BF16}>", "stream_yzslab", name,
               "streamfused.cu", TPU + "streamfused.py:399", ms, plain_ms,
               2 * nf * (2 * lcells + 2 * m * X * (Ly + Lz + 2 * m)),
               flops * lcells, None, k, local, 4.0 / k, dtype=BF16)
        del yz_args
        torch.cuda.empty_cache()
    for mshape, axis, shape in (((2, 2), 0, (4, 512, 1024)),
                                ((2, 2), 1, (512, 4, 1024)),
                                ((2, 2), 1, (4, 4, 1024)),
                                ((4,), 0, (4,) + CONFIG5_GRID[1:])):
        mesh = virtual_mesh(mshape)
        nxt, prv = ring_of(mesh, axis)
        hi = [rand16(shape) for _ in range(4)]
        lo = [rand16(shape) for _ in range(4)]
        call, meta = remote.build_ring_exchange_call(shape, bf16, device=dev)
        ms = time_ms(lambda: call(hi, lo, nxt, prv), 50)
        call.state.check_drained(meta)
        plain_state = remote.RingState(meta, 4, dev)
        plain_ms = time_ms(lambda: remote.plain_ring_exchange(
            hi, lo, nxt, prv, meta, plain_state), 3)
        outs = [torch.empty_like(t) for t in hi + lo]

        def copies(hi=hi, lo=lo, outs=outs, nxt=nxt, prv=prv):
            for i in range(4):
                outs[i].copy_(hi[prv[i]])
                outs[4 + i].copy_(lo[nxt[i]])

        library_ms = time_ms(copies, 50)
        name = "x".join(map(str, shape))
        record(f"ring_exchange<{name},{BF16}>", "ring_exchange", name,
               "remote.cu", TPU + "remote.py:136", ms, plain_ms,
               2 * 4 * 2 * meta["slab_bytes"], 0, library_ms, 4, shape,
               None, dtype=BF16)
        kernels_out[-1].update(
            mesh=list(mshape), chunks=[meta["chunk_axis"], meta["nchunks"]],
            nslots=meta["nslots"], blocks=call.state.blocks,
            device_ms=device_ms(lambda: call(hi, lo, nxt, prv)),
            library_device_ms=device_ms(copies))
        del hi, lo, outs, call
        torch.cuda.empty_cache()
    # K3, its shells, K6 and K9 in bfloat16 at the shapes of their main-path
    # runs (bytes at 2 B a cell): K3 RAW at 512^3, every family at its
    # BF16_FUSE k; K3's sharded mode, one hi z shell and K9 on a 2x2 shard
    # and K6 on a --mesh 4 shard of 1024^3 (heat3d, wave3d, k = 8); and
    # the pad-free kinds of advect3d and grayscott3d on the shards of
    # 512^3, float32 k = 4 and bfloat16 k = 8
    def micro_of(name):
        return TPU + {"advect3d": "fused.py:184", "grayscott3d": "fused.py:203",
                      "sor3d": "fused.py:224"}.get(name, "fused.py:280")

    def time_slabs(name, st, k, grid, padded=False):
        """K9 on one 2x2 shard and K6 on one --mesh 4 shard of ``grid``
        (with ``padded`` also K3's sharded mode and one hi z shell of the
        2x2 shard), each beside its plain version, recorded."""
        isz, nf, m = st.dtype.itemsize, st.num_fields, k_step_margin(st, k)
        dtype = BF16 if st.dtype == bf16 else None
        tag = f"{name},{BF16}" if dtype else name
        flops = FLOPS_PER_CELL[name] * k

        def pieces(shape):
            return tuple(rand(shape).to(st.dtype) for _ in range(nf))

        Lz, Ly, X = local = (grid[0] // 2, grid[1] // 2, grid[2])
        lcells = math.prod(local)
        if padded:
            pshape = (Lz + 2 * m, Ly + 2 * m, X)
            ins = pieces(pshape)
            ms = time_ms(lambda: fused.fused_step_padded(ins, st, k, grid,
                                                         (0, 0)), 10)
            plain_ms = time_ms(lambda: fused.plain_step_padded(
                ins, st, k, grid, (0, 0)), 1)
            record(f"fused_step_padded<{tag}>", "fused_step_padded", name,
                   "fused.cu", micro_of(name), ms, plain_ms,
                   isz * nf * (math.prod(pshape) + lcells), flops * lcells,
                   None, k, local, 4.0 / k, dtype=dtype)
            del ins
            shells = fused.build_overlap_shell_calls(st, local, grid, k,
                                                     (0, 1), device=dev)
            strips = pieces((4 * m, Ly + 2 * m, X))
            org = (Lz - 2 * m, 0)
            ms = time_ms(lambda: shells[0](org, *strips), 20)
            plain_ms = time_ms(lambda: fused.plain_step_padded(
                strips, st, k, grid, org), 2)
            scells = 2 * m * Ly * X
            record(f"fused_shell<{tag}>", "fused_shell", name, "fused.cu",
                   TPU + "fused.py:1284", ms, plain_ms,
                   isz * nf * (math.prod(strips[0].shape) + scells),
                   flops * scells, None, k, (2 * m, Ly, X), 16.0 / k,
                   dtype=dtype)
            del strips
        yz_args = (pieces(local), pieces((m, Ly, X)), pieces((m, Ly, X)),
                   pieces((Lz, m, X)), pieces((Lz, m, X)),
                   [pieces((m, m, X)) for _ in range(4)], st, k, grid, (0, 0))
        ms = time_ms(lambda: fused.fused_yzslab(*yz_args), 10)
        plain_ms = time_ms(lambda: fused.plain_yzslab(*yz_args), 1)
        record(f"fused_yzslab<{tag}>", "fused_yzslab", name, "fused.cu",
               TPU + "fused.py:562", ms, plain_ms,
               isz * nf * (2 * lcells + 2 * m * X * (Ly + Lz + 2 * m)),
               flops * lcells, None, k, local, 4.0 / k, dtype=dtype)
        del yz_args
        zl = (grid[0] // 4, grid[1], grid[2])
        zcells = math.prod(zl)
        core, lo, hi = pieces(zl), pieces((m,) + zl[1:]), pieces((m,) + zl[1:])
        ms = time_ms(lambda: fused.fused_zslab(core, lo, hi, st, k, grid[0],
                                               0), 10)
        plain_ms = time_ms(lambda: fused.plain_zslab(core, lo, hi, st, k,
                                                     grid[0], 0), 1)
        record(f"fused_zslab<{tag}>", "fused_zslab", name, "fused.cu",
               TPU + "fused.py:432", ms, plain_ms,
               isz * nf * (2 * zcells + 2 * m * zl[1] * zl[2]),
               flops * zcells, None, k, zl, 4.0 / k, dtype=dtype)
        del core, lo, hi
        torch.cuda.empty_cache()

    for name, k in BF16_FUSE.items():
        st = main_stencil(name, BF16)
        nf = st.num_fields
        fields = tuple(rand16(MAIN) for _ in range(nf))
        kern = fused.make_fused_step(st, MAIN, k, device=dev)
        ms = time_ms(lambda: kern(fields), 10)
        plain_ms = time_ms(lambda: fused.plain_steps(fields, st, k), 1)
        record(f"fused_step<{name},{BF16}>", "fused_step", name, "fused.cu",
               micro_of(name), ms, plain_ms, 2 * nf * 2 * cells,
               FLOPS_PER_CELL[name] * k * cells, None, k, MAIN, 1.0 / k,
               dtype=BF16)
        del fields
        torch.cuda.empty_cache()
    for name in ("heat3d", "wave3d"):
        time_slabs(name, main_stencil(name, BF16), 8, BIG, padded=True)
    for name in ("advect3d", "grayscott3d"):
        time_slabs(name, main_stencil(name), 4, MAIN)
        time_slabs(name, main_stencil(name, BF16), 8, MAIN)
    # K4 / K5, K7 and K8 in bfloat16 at the shapes of their main-path runs
    # (bytes at 2 B a cell): K4 / K5 on one 2x2 shard's padded block (heat3d
    # and wave3d of 1024^3, heat3d27 and heat3d4th of 512^3) beside one
    # F.conv3d in bfloat16; K7 at 16384^2 beside one F.conv2d in bfloat16;
    # K8 at 16384^2 (RAW) and on one --mesh 4 shard's padded block
    # (PADDED), every float family at its BF16_FUSE2D k
    bf16_tol = 32 * 2.0 ** -7
    for name, grid in (("heat3d", BIG), ("wave3d", BIG), ("heat3d27", MAIN),
                       ("heat3d4th", MAIN)):
        st = make_stencil(name, dtype=BF16)
        h, nf = st.halo, st.num_fields
        local = (grid[0] // 2, grid[1] // 2, grid[2])
        lcells = math.prod(local)
        padded = tuple(s_ + 2 * h for s_ in local)
        ins = (rand16(padded),) + ((rand16(local),) if nf == 2 else ())
        comp = kernels.make_pallas_compute(st, device=dev)
        ms = time_ms(lambda: comp(ins), 20)
        plain_ms = time_ms(lambda: st.update(ins), 3)
        scale = max(float(ins[0].float().abs().max()), 1.0)
        library_ms = time_ms(padded_library_call(
            name, st, ins, atol=bf16_tol * scale), 10)
        wrapper = "zchunk_wave" if name == "wave3d" else "zchunk_heat"
        record(f"{wrapper}<{name},{BF16}>", wrapper, name, "zchunk.cu",
               TPU + ("kernels.py:138" if name == "wave3d"
                      else "kernels.py:133"), ms, plain_ms,
               2 * (math.prod(padded) + lcells * nf),
               FLOPS_PER_CELL[name] * lcells, library_ms, 1, local, 4.0,
               dtype=BF16)
        if name == "heat3d":
            # one bf16 sharded step on 2x2 at 1024^3, split as the f32 one
            del ins
            mesh = virtual_mesh((2, 2))
            fields = stepper.shard_fields((rand16(grid),), mesh, 3)
            step = stepper.make_sharded_step(st, mesh, grid, compute_fn=comp)
            ex = lambda: [halo.exchange_and_pad(fields[0], mesh, h,
                                                st.bc_value[0])]
            pads = ex()
            new = [comp((pads[0][i],)) for i in range(4)]
            masks = [driver.frame_mask(
                local, grid, stepper.shard_offsets(c, local), h, dev)
                for c in mesh.coords()]
            split.append({
                "stencil": name, "grid": list(grid), "mesh": [2, 2],
                "dtype": BF16, "exchange_pad_ms": time_ms(ex, 5),
                "kernel_ms": time_ms(lambda: [comp((pads[0][i],))
                                              for i in range(4)], 5),
                "repin_ms": time_ms(
                    lambda: [torch.where(masks[i], fields[0][i],
                                         new[i][0]) for i in range(4)], 5),
                "step_ms": time_ms(lambda: step(fields), 5)})
            del fields, pads, new, masks
            ins = ()
        del ins
        torch.cuda.empty_cache()
    st = make_stencil("heat2d", dtype=BF16)
    ins = (rand16((H + 2, W + 2)),)
    comp = kernels.make_pallas_compute(st, device=dev)
    ms = time_ms(lambda: comp(ins), 20)
    plain_ms = time_ms(lambda: st.update(ins), 3)
    a = st.params["alpha"]
    w2 = torch.tensor([[0, a, 0], [a, 1 - 4 * a, a], [0, a, 0]],
                      dtype=torch.float32, device=dev)[None, None].to(bf16)
    x2 = ins[0][None, None]
    err = float((F.conv2d(x2, w2, padding=0)[0, 0].float()
                 - st.update(ins)[0].float()).abs().max())
    if not err <= bf16_tol * max(float(ins[0].float().abs().max()), 1.0):
        fail(f"bf16 F.conv2d yardstick for heat2d disagrees with the plain "
             f"update: max|d| {err:.3e}")
    library_ms = time_ms(lambda: F.conv2d(x2, w2, padding=0), 10)
    record(f"whole2d<heat2d,{BF16}>", "whole2d", "heat2d", "whole2d.cu",
           TPU + "kernels.py:254", ms, plain_ms,
           2 * ((H + 2) * (W + 2) + cells2d), FLOPS_PER_CELL["heat2d"]
           * cells2d, library_ms, 1, GRID2D, 1.0, dtype=BF16)
    del ins, x2
    split.append(split2d(st, GRID2D, rand16))
    for name, k in BF16_FUSE2D.items():
        st = main_stencil(name, BF16)
        nf, m = st.num_fields, k_step_margin(st, k)
        flops = FLOPS_PER_CELL[name] * k
        fields = tuple(rand16(GRID2D) for _ in range(nf))
        kern = fullgrid.make_fullgrid_step(st, GRID2D, k, device=dev)
        ms = time_ms(lambda: kern(fields), 5)
        plain_ms = time_ms(lambda: fused.plain_steps(fields, st, k), 1)
        record(f"fullgrid_step<{name},{BF16}>", "fullgrid_step", name,
               "fullgrid.cu", TPU + "fullgrid.py:120", ms, plain_ms,
               2 * nf * 2 * cells2d, flops * cells2d, None, k, GRID2D,
               1.0 / k, dtype=BF16)
        del fields
        local = (H // 4, W)
        pshape = (H // 4 + 2 * m, W)
        ins = tuple(rand16(pshape) for _ in range(nf))
        ms = time_ms(lambda: fullgrid.fullgrid_padded(ins, st, k, H, 0), 10)
        plain_ms = time_ms(lambda: fused._plain_window_steps(
            ins, st, k, (-m, 0), GRID2D, False, (1,)), 1)
        record(f"fullgrid_padded<{name},{BF16}>", "fullgrid_padded", name,
               "fullgrid.cu", TPU + "fullgrid.py:120", ms, plain_ms,
               2 * nf * (math.prod(pshape) + math.prod(local)),
               flops * math.prod(local), None, k, local, 4.0 / k, dtype=BF16)
        del ins
        torch.cuda.empty_cache()
    # CLI ms/step of every --exchange rdma run beside its ppermute twin
    rdma_vs_ppermute = []
    for r in mesh_results:
        if "rdma" not in r["flags"]:
            continue
        twin_flags = [f for f in r["flags"] if f not in ("--exchange",
                                                         "rdma")]
        twin = [t for t in mesh_results if t["stencil"] == r["stencil"]
                and t["flags"] == twin_flags and t["grid"] == r["grid"]]
        rdma_vs_ppermute.append({
            "stencil": r["stencil"], "grid": r["grid"], "flags": r["flags"],
            "rdma_ms_per_step": r["ms_per_step"],
            "ppermute_ms_per_step": twin[0]["ms_per_step"] if twin else None,
            "ring_launches": {k_: v for k_, v in r["launches"].items()
                              if k_.startswith("ring_exchange")}})
    for kk in kernels_out:
        if kk["launches"] < 1:
            fail(f"{kk['name']} was not launched on the main path")
    # K10 beside the overlapped-window kernel of the same shape and source
    by_name = {kk["name"]: kk for kk in kernels_out}
    stream_vs_window = []
    for kk in kernels_out:
        wrapper, _, rest = kk["name"].partition("<")
        window = {"stream_step": "fused_step", "stream_zslab": "fused_zslab",
                  "stream_yzslab": "fused_yzslab"}.get(wrapper)
        if window and f"{window}<{rest}" in by_name:
            stream_vs_window.append({
                "stream": kk["name"], "ms": kk["ms"],
                "window": f"{window}<{rest}",
                "window_ms": by_name[f"{window}<{rest}"]["ms"],
                "bound_ms": kk["bound_ms"], "shape": kk["shape"]})
    # the redesigned kernels (rows 5-11, 15-19), one line each: this run's
    # ms beside the first design's (OLD_MS) and the fraction of the bound
    for kk in kernels_out:
        wrapper = kk["name"].partition("<")[0]
        if wrapper not in REDESIGNED:
            continue
        old = OLD_MS.get(kk["name"])
        emit({"phase": "redesign",
              "name": kk["name"], "old_ms": old,
              "old_from": "PERF.md section 6" if old else None,
              "ms": kk["ms"], "bound_ms": kk["bound_ms"],
              "fraction_of_bound": kk["bound_ms"] / kk["ms"],
              "library_ms": kk["library_ms"],
              "speedup": old / kk["ms"] if old else None,
              **{f: kk[f] for f in ("device_ms", "library_device_ms")
                 if f in kk}})
    # the batched kernels of phase 5h's runs, at their shapes there (a
    # block's members in one launch), each held to its plain version on the
    # same batch (bit for bit; K3's float32 heat kind within 1e-4: it
    # reassociates taps) and timed beside it; launches: the 5h runs'
    # (",ensemble" keys)
    def ens_record(entry, wrapper, name, src, replaces, fn, plain, reps,
                   plain_reps, atol, moved, flops, library_ms, k, shape,
                   per_step, members, dtype="float32"):
        errs.pop(entry, None)  # the line's error: this shape's, not N = 3's
        got, ref = fn(), plain()
        torch.cuda.synchronize()
        compare(entry, got, ref, atol, None)
        del got, ref
        record(entry, wrapper, name, src, TPU + replaces, time_ms(fn, reps),
               time_ms(plain, plain_reps), moved, flops, library_ms, k,
               shape, per_step)
        key = f"{wrapper}[{name},ensemble]"
        kernels_out[-1].update(
            dtype=dtype, members=members, atol=atol,
            launches=main_launches.get(key, 0),
            groups_launches=p5i["launches"].get(key, 0),
            obs_launches=p5j["launches"].get(key, 0),
            serve_launches=p5k["launches"].get(key, 0),
            costmodel_launches=p5l["launches"].get(key, 0))

    st = make_stencil("life")
    ins = ((rand((64, 130, 130)) < 0.35).to(torch.int32),)
    comp = kernels.make_pallas_compute(st, device=dev)
    ens_record("whole2d<life,ensemble>", "whole2d", "life", "whole2d.cu",
               "kernels.py:260", lambda: comp(ins), lambda: st.update(ins),
               20, 3, 0.0, 4 * 64 * (130 * 130 + 128 * 128),
               FLOPS_PER_CELL["life"] * 64 * 128 * 128, None, 1,
               (64, 128, 128), 1.0, 64, "int32")
    st = make_stencil("heat2d")
    fields = (rand((64,) + BASE2D),)
    plain = driver.make_step(st, BASE2D)

    def run_plain8(fields=fields, plain=plain):
        for _ in range(8):
            fields = plain(fields)
        return fields

    cells = 64 * math.prod(BASE2D)
    ens_record("fullgrid_step<heat2d,ensemble>", "fullgrid_step", "heat2d",
               "fullgrid.cu", "fullgrid.py:120",
               lambda: fullgrid.fullgrid_step(fields, st, 8), run_plain8,
               20, 3, 0.0, 2 * 4 * cells,
               FLOPS_PER_CELL["heat2d"] * 8 * cells, None, 8,
               (64,) + BASE2D, 1.0 / 8, 64)
    del fields
    st = make_stencil("heat3d")
    g256 = (256, 256, 256)
    fields = (rand((8,) + g256),)
    plain = driver.make_step(st, g256)

    def run_plain4(fields=fields, plain=plain):
        for _ in range(4):
            fields = plain(fields)
        return fields

    cells = 8 * math.prod(g256)
    for wrapper, src, replaces, fn, atol in (
            ("fused_step", "fused.cu", "fused.py:280",
             lambda: fused.fused_step(fields, st, 4), 1e-4),
            ("stream_step", "streamfused.cu", "streamfused.py:377",
             lambda: streamfused.stream_step(fields, st, 4), 0.0)):
        ens_record(f"{wrapper}<heat3d,ensemble>", wrapper, "heat3d", src,
                   replaces, fn, run_plain4, 10, 3, atol, 2 * 4 * cells,
                   FLOPS_PER_CELL["heat3d"] * 4 * cells, None, 4,
                   (8,) + g256, 1.0 / 4, 8)
    del fields
    # one shard of the ensemble mesh run (4 members of a (128, 128, 256)
    # block) and of the wave3d --mesh 2,2 run (4 members)
    local = (128, 128, 256)
    pshape = (4,) + tuple(x + 2 for x in local)
    cells = 4 * math.prod(local)
    p = rand(pshape)
    comp = kernels.make_pallas_compute(st, device=dev)
    w, _ = stencil_weight("heat3d", st)

    def conv(p=p, w=w):
        return F.conv3d(p[:, None], w, padding=0)

    err = float((conv()[:, 0] - st.update((p,))[0]).abs().max())
    if not err <= 1e-4:
        fail(f"F.conv3d yardstick for the batched heat3d update "
             f"disagrees with the plain update: max|d| {err:.3e}")
    ens_record("zchunk_heat<heat3d,ensemble>", "zchunk_heat", "heat3d",
               "zchunk.cu", "kernels.py:133", lambda: comp((p,)),
               lambda: st.update((p,)), 20, 3, 0.0,
               4 * (math.prod(pshape) + cells),
               FLOPS_PER_CELL["heat3d"] * cells, time_ms(conv, 20), 1,
               (4,) + local, 1.0, 4)
    stw = make_stencil("wave3d")
    up = rand((4,) + local)
    compw = kernels.make_pallas_compute(stw, device=dev)
    # the new u only: slot 1 is dead (carry_map=(None, 0)), the kernel's
    # compute_fn hands u_prev through and the plain update the old u
    ens_record("zchunk_wave<wave3d,ensemble>", "zchunk_wave", "wave3d",
               "zchunk.cu", "kernels.py:138", lambda: compw((p, up))[:1],
               lambda: stw.update((p, up))[:1], 20, 3, 0.0,
               4 * (math.prod(pshape) + 2 * cells),
               FLOPS_PER_CELL["wave3d"] * cells, None, 1, (4,) + local, 1.0,
               4)
    del p, up
    # one shard of heat3d 512^3 x 2 on --mesh 2,2 --fuse-kind stream: the
    # core, its z and y slabs and its corners, 2 members
    Lz, Ly, X = local = (256, 256, 512)
    m = k_step_margin(st, 4)

    def two(shape):
        return (rand((2,) + shape),)

    yz_args = (two(local), two((m, Ly, X)), two((m, Ly, X)),
               two((Lz, m, X)), two((Lz, m, X)),
               [two((m, m, X)) for _ in range(4)], st, 4, MAIN, (0, 0))
    cells = 2 * math.prod(local)
    ens_record("stream_yzslab<heat3d,ensemble>", "stream_yzslab", "heat3d",
               "streamfused.cu", "streamfused.py:399",
               lambda: streamfused.stream_yzslab(*yz_args),
               lambda: fused.plain_yzslab(*yz_args), 10, 2, 0.0,
               4 * 2 * (2 * math.prod(local)
                        + 2 * m * X * (Ly + Lz + 2 * m)),
               FLOPS_PER_CELL["heat3d"] * 4 * cells, None, 4, (2,) + local,
               4.0 / 4, 2)
    del yz_args
    torch.cuda.empty_cache()
    emit({"phase": "timing", "ok": True, "seconds": took(),
          "stream_vs_window": stream_vs_window,
          "rdma_vs_ppermute": rdma_vs_ppermute, "exchange_ab": exchange_ab,
          "ring_vs_k10": ring_vs_k10,
          "total_seconds": round(time.perf_counter() - t_start, 3),
          "card": smi,
          "bytes_per_s": bw, "flops32_per_s": flops32,
          "sharded_step_split": split,
          "note": "sharded figures: 4 shards on 1 card, decomposition "
                  "overhead, not scaling"})
    print(smi, flush=True)
    emit({"kernels": kernels_out})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card_kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--mp-worker":
        sys.exit(mp_worker(sys.argv[2]))
    sys.exit(main())
