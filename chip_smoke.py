"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py                  # everything; what the last line reports
    python3 chip_smoke.py --kernels-only   # phases 1-3 (K2 too), K7 on seeded states, K10 and K11 on the walks' states, the kernels' timings; no result line
    python3 chip_smoke.py --kernels-only --k1-baseline OLD.cu   # and K1 held element by element and timed beside the parent's source (K4's code too)
    python3 chip_smoke.py --kernels-only --k7-baseline OLD.cu   # and K7 timed beside another source of it
    python3 chip_smoke.py --kernels-only --k2-baseline OLD.cu   # and K2 held bit for bit and timed beside another
    python3 chip_smoke.py --kernels-only --k8-baseline OLD.cu[,OTHER.cu]   # and K8 the same
    python3 chip_smoke.py --kernels-only --k9-baseline OLD.cu   # and K9 held bit for bit and timed beside another
    python3 chip_smoke.py --kernels-only --k10-baseline OLD.cu  # and K10 held bit for bit and timed beside another
    python3 chip_smoke.py --kernels-only --k11-baseline OLD.cu[,OTHER.cu]  # and K11 the same
    python3 chip_smoke.py --hardware-only  # phases 1-2, 14 and 15: the hardware loop, the fleet over ranks, the CLI; no result line
    python3 chip_smoke.py --graphs-only    # phases 1-2 and 16: the entry points' CUDA graphs against eager; no result line

Phases, each printing its results (any failure raises, so the script exits
non-zero before the last line):

1. device: a CUDA card is required (there is no CPU path); prints the card's
   name and power limit as nvidia-smi reports them;
2. build: compiles the CUDA kernels from `quaternion_mpc_tpu_torch/csrc/`,
   one nvcc per source, all at once, and prints what ptxas reports of each
   (registers, stack, spills); K1 must not spill at any of its 14 kernels
   (seven instantiations, f32 and f64) and keep `knot`'s registers at 12 x 12,
   K4's four lines must be what they were, nor may K7 spill in
   f32 or f64, nor K2's 52 kernels, nor K8's 26 (f32 and f64: the
   quaternion SRB and the Euler SRB by the midpoint rule and forward Euler
   at one to four feet, the attitude model), which keep no stack but the
   Euler SRB's sine and cosine (`K8_STACK`);
3. kernel vs plain: K1 (`riccati_sweep`) against `riccati_sweep_ref` on the
   Go1 fleet's real expansions, f32 and f64, N in {10, 20}, B in {1, 7, 1000,
   4096, 16385} (one warp, a ragged single tile, a ragged last tile, full
   tiles, many tiles and one scenario over), the horizons the 12 x 12
   single problems solve at, N in {15, 30}, B in {1, 7, 256}, and the
   hardware loop's, N in {6, 8}, B in {1, 7}; K4's two entries, `assoc_scan`
   against `assoc_scan_ref` and `assoc_backward` against
   `assoc_backward_ref`, on the golden fixture (N=20, B in {1, 7, 256}), a
   standing robot (N=10, B in {1, 7}) and the longest tree (N=30, B in {1, 7,
   256}). In f64 kernel and plain agree to 1e-10 of scale; in f32 the kernel
   and the f32 plain version are each held against the plain version in f64;
   K2 (`line_search`, the line search of an iLQR iteration, one kernel body
   over a model) against `line_search_ref` on a first iteration's inputs:
   the quaternion SRB at the fleet step's (N=10, 8 alphas, B in {1, 7,
   4096}), the hardware loop's (N in {6, 8}, 12 alphas, B=1; N=6 at B=7
   too), the golden fixture's (N=20, B in {1, 256}, leaves shared along B)
   and the humanoid's (two feet, N=20, B in {1, 7}); the Euler SRB at the
   convex fleet's (midpoint rule, N=10, 8 alphas, B in {1, 7, 4096}) and the
   golden convex fixture's (forward Euler, N=30, 12 alphas, B in {1, 256});
   the attitude model at the falling_cat fleet's (N=40, 12 alphas, B in {1,
   7, 4096}); a hard case (an alpha whose rollouts overflow to Inf / NaN, a
   scenario that accepts nothing, done scenarios, per-knot w and cb, Qdf) and
   a runaway attitude case (the same on the falling_cat problem);
   the per-alpha costs J_k first, then xs, us and J, f64 to 1e-10 of scale,
   f32 to 1e-4 against the f32 plain version where both select the same
   alpha, every f32 flip a margin case (counted and printed); a rollout whose
   quaternion runs off the unit sphere (`kernels.line_search.conditioned`:
   falling_cat's steep starts at a large step) is held by its decision
   alone, and a scenario whose plain selection runs away not at all
   (counted and printed; none in any other model's checks);
   K8 (`expansions`, the knot expansions of a backward pass) against
   `knot_expansions_ref`, every element of its eight outputs: the
   quaternion SRB at the fleet step's shape (N=10, B in {1, 7, 31, 33, 130,
   4096}), the hardware loop's (N in {6, 8}, B=1), the golden fixture's
   (N=20, B=256, leaves shared along B), the humanoid's (two feet, N=20,
   B=33) and the fleet's with per-knot w and cb and a terminal weight
   (B=4096); the Euler SRB at the convex fleet's (f32 N=10 B in {7, 4096},
   f64 B=256) and the convex fixture's (forward Euler, N=30, f64 B in {1,
   256}, f32 B=33); the attitude model at the falling_cat fleet's (N=40,
   f32 B in {7, 4096}, f64 B in {1, 256}) and at its iterate after 1 x 4
   iterations, runaway starts included (B=4096, f32 and f64); multipliers
   drawn so that some rows are active: f64 to 1e-12 of each output's scale
   (each scenario's for the other models), f32 to 1e-5, the SRBs bit for
   bit wherever B > 1, the attitude model with as many non-finite elements
   as the plain version in every output;
4. main path: the Go1 quaternion-MPC fleet controller (N=10, 2 AL x 5 iLQR,
   8 line-search alphas) at B in {256, 4096, 16384}, f32, counting K1, K2
   and K8 launches (10 each a solve); then f64 at B=256 against the same
   controller on the CPU;

   From here on every counted path holds K2 to one launch an iLQR iteration
   of a solve of a model it has (beside K1 or K4's fused entry: the
   quaternion SRB's, the convex fleet's and fixture's, falling_cat's) and to
   none in the bicycle's, and K8 to as many as K2's (K8 has every model K2
   has), and adds what it counted to its instantiation's line and to K8's
   in the kernels output, by path;
5. fixture guard: the golden standing fixture (default SolverOptions) in f32
   and f64 against the reference's golden optimum, through the sweep (B=256)
   and through the associative scan (f32 at B=1 under backend="auto", f64
   at B=4 under "assoc": `assoc_backward` al x ilqr times a solve);
6. timing: p50 of 10 controller steps per B after warm-up; K1 alone by CUDA
   events (f32 N=10 at B in {1, 256, 4096, 16384}, N=20 at B=1, f64 at
   B=4096), both entries of K4 alone and K2 alone (f32 N=10 K=8 at B in
   {4096, 16384}, the hardware ticks' N=6 and 8 K=12 at B=1, f64 N=10 at
   B=4096; the convex fleet's f32 B=4096 and f64 B=256, the convex fixture's
   f64 N=30 B in {1, 256}, the falling_cat fleet's N=40 f32 and f64 B=4096
   and f64 B=1) and K8 alone (f32 N=10 at B in {4096, 16384}, the hardware
   tick's N=6 at B=1, f64 N=10 at B in {256, 4096}; the convex fleet's f32
   B=4096 and f64 B=256, the convex fixture's f64 N=30 B in {1, 256}, the
   falling_cat fleet's f32 N=40 B=4096 and f64 B=1), and K1 at each
   instantiation below 12 x 12 and with the cross term (falling_cat's 6 x 3
   f32 N=40 B=4096 and f64 B=1, the humanoid's 12 x 6 N=20 B in {1, 256},
   the double integrator's and the pendulum's at N=20 B=4096, the bicycle's
   4 x 2 with lux N=30 B in {1, 4096}, the Go1's 12 x 12 with lux), each in
   turns with the parent's launch of the same problem (`embed` into 12 x 12),
   each beside its bound
   on the card (the larger of bytes over
   3.35 TB/s and operations over the peak rate of the type) and the plain
   version's time;
7. single-robot latency: the five B=1 rows of the reference's bench (cold
   N=10 and N=20, warm RTI N=10 and N=20, dual-warm RTI N=10), p50 ms per
   tick of build + solve, under backend="auto" (K4) and "sweep" (K1),
   counting each kernel's launches per tick;
8. convex fleet: the Euler convex-MPC baseline (N=10, 1 AL x 5 iLQR, 8
   alphas) at B=4096 f32, counting K1, K2 and K8 launches (5 each), its mean
   Σfz beside the same solve's with the plain line search, its p50 step and
   a profile of one step, and f64 at B=256 against the CPU;
9. profile: device time by kernel over one B=4096 quaternion step, with the
   launches, host time and device time of its `expansions` ranges (K8's
   launches, one an iLQR iteration), and over one B=1 N=10 cold tick under
   each backend;
10. closed loop (`runtime.step`, f32 unless noted): the CLI's standing fleet
   (`make_fleet_standing_step`, 2 AL x 5 iLQR) at B=4096 for 50 ticks,
   exactly 10 K1 launches a tick, all alive and finite, final mean height
   error <= 0.02 m; the bench's warm-started walking RTI fleet
   (`make_fleet_walking_step`, 1 AL x 3 iLQR, penalty 10, 8 alphas) at
   B=4096 for 300 ticks at 0.4 m/s, in f32 and in f64 (both beside phase
   11's quality runs, see there): exactly 3 K1
   launches a tick and no K4, every robot alive past 0.9 m with mean velocity
   error < 0.05 m/s and height error < 0.01 m over the last 150 ticks
   (tests/test_walking.py's RTI bounds), and, printed, not held, how many
   robots of the f32 fleet meet them when each start is moved by 1e-6 m
   (the held fleet's robots are identical: one f32 trajectory, whose fate
   rounding can set); then the f32 p50 tick at the
   bench's 0.3 m/s; one robot (B=1)
   under "auto" for 20 ticks, exactly 3 K4 (`assoc_backward`) launches a
   tick and no K1; the reference's stairs gate (`phase_stairs_gate`,
   tests/test_terrain_walking.py:43-52: one robot on stairs of 0.17 m rise
   and 0.30 m run at 0.3 m/s, 2 AL x 4 iLQR, 400 ticks) through the graphed
   per-scenario walking step, held in f64 (alive, x > 0.7 m, z > 0.55 m),
   printed in f32; K10, the walking pre (`phase_walking_pre`), against its
   plain version on the states of 300-tick walks on flat, slope and stairs
   and of the estimated fleet, f32 and f64 at B from 4096 to 1, every
   element of every output equal, and timed at B=4096 and B=1; K11, the
   SRB plant's tick and the safety mask (`phase_srb_post`), against its
   plain version on the inputs one eager tick hands it from those states and
   from the standing fleet's (pushed and not), f32 and f64 at B from 4096 to
   1, every element of every output equal, and timed at B=4096 and B=1;
   one
   B=4096 tick under `torch.cuda.set_sync_debug_mode("error")` (a tick never
   returns to the host); 10 f64 ticks at B=64 (a velocity spread, one robot
   pushed) on the card against the CPU; and a profile of one B=4096 walking
   tick, split between the step's pre / solve / post ranges (the pre range
   K10 and the post range K11, each with at most three other launches) and
   the solver's `expansions`; every walking tick of every phase launches K10
   once, every other tick none; every standing, walking and estimated SRB
   tick (fleet and per-scenario, eager and replayed, the CLI's) launches K11
   once, the actuated and hardware ticks none;
11. estimated fleet (`make_fleet_estimated_step`): the bench's fleet of
   B=4096 robots with the BasicKF in the loop under sensor noise (N=10, 2 AL x
   5 iLQR, 8 alphas, f32, noise from a seeded CUDA generator): p50, min and
   max of 10 ticks from the same carry after 2 warm-ups, exactly 10 K1
   launches a tick and no K4 (at B=1: 10 of K4's `assoc_backward`, no K1);
   one tick with the KF and one with the EKF (a mocap sample due and fused)
   under `torch.cuda.set_sync_debug_mode("error")`;
   tests/test_estimated_walking.py's 200 noisy ticks at 0.3 m/s (2 x 4; all
   alive, min x > 0.25 m, |p_est − p_true| < 0.06 m) in f64 at B=256 and in
   f32 at B=4096; the EKF with mocap on at B=256 in f64, 100 ticks at 0.4 m/s
   (|p_est − p_true| < 0.01 m). These runs are host-bound and only held to
   bounds, so the f64 estimated fleet, the EKF fleet, 10 noisy f64 ticks at
   B=64 on the card against the CPU on the same noise tensors, and phase
   10's 300-tick walking fleets (f32, f64) and card-against-CPU ticks run as
   worker processes (`--worker NAME`) beside the main process's f32
   estimated fleet; then a profile of one tick split
   between the pre / solve / post ranges and the estimator's own (`est`,
   inside post).

12. the single-problem path (`solver.al_ilqr.make_solver`, which lifts a
   `TrajOptProblem` to the fleet solver's sweep backend, so every solve runs
   K1, at the problem's own size): K1 through its wrapper against the plain
   sweep at the problem's own size, (ne, nu) in {(12, 6), (6, 3), (2, 1),
   (4, 2)} (humanoid, falling_cat, pendulum, double integrator) and a drawn
   5 x 3 (embedded in 6 x 3), N in {20, 40}, B in {1, 7, 4096}, f32 and f64,
   phase 3's tolerances, and against the parent's launch (`embed` into
   12 x 12; the elements that differ counted); K1 with the cost's cross
   term lux, which a problem with state
   rows Cx hands it, against the plain sweep with the cross term: a bicycle
   fleet whose rows mix state and inputs (ne = 4, nu = 2, at its own size), N in
   {15, 30}, B in {1, 7, 4096}, and the Go1 expansions with drawn mixed rows
   (12 x 12, not embedded), N = 10, B in {7, 4096}, f32 and f64; in the main
   process, counted: one default solve (the quat fixture, 6 x 10: exactly 60
   K1 launches, no K4) and one of the convex fixture (60 K1, 60 K2, 60 K8),
   one falling_cat receding tick (2 x 8: 16 K1, 16 K2, 16 K8) and the
   bicycle's receding solves (state rows Cx; 2 x 8: 16 K1 launches each, the
   kernel with the cross term; no counted path calls `embed`); a falling_cat fleet (B=4096, f32, N=40,
   3 x 25, starts at 100-175 degrees about seeded axes): one counted warm-up
   solve (75 K1, 75 K2 and 75 K8 launches), p50 / min / max of 3 more, one
   solve of the same starts in f64, both fleets held to the reference's
   bounds in every start but the few beyond 160 degrees that run away (the
   cost is unbounded below in |q|; none up to 160 degrees may; the runaway
   sets and the held count printed beside the parent's, `CAT_PARENT`), one
   profiled solve. As workers beside phase 11's: the three
   golden C++ fixtures (quat N=20, trot nu=6, convex N=30 forward Euler) at
   default options in f64, one problem and B=256, against the JSON at the
   JAX tests' bounds; the three branch scenarios at their own sizes in f64
   against tests/test_branch_configs.py's open-loop bounds, each through
   `solve_scenario` twice (the first call captures its graph, the second
   replays the kept graph: al x ilqr launches, the first's bits); the falling_cat
   receding loop in f64 to tick 50 (error < 0.05), 16 K1 and 16 K2 launches a tick, one
   tick under `set_sync_debug_mode("error")`.

13. the joint-level tier (`runtime.step.make_actuated_walking_step` and
   `make_estimated_actuated_step`; the plant's control period is K7,
   `articulated_step`): a mixed fleet (flat, onto the slope, up to a stair
   riser; B=4096, f32) trots 25 ticks, its robots perturbed by seeded noise
   give K7's inputs; K7 against the plain step (the torch.func leg
   dynamics) at B in {1, 7, 4096}, n_sub=80, f64 to 1e-9 of scale, f32 to
   1e-3 against the f64 plain step (where f32 rounding flips a stick / slip
   decision in the plain step itself, at most 5% of the scenarios, against
   the f32 plain step); the per-scenario SRB steps (standing, walking,
   estimated standing and walking) with one robot unbatched, f64, 3 ticks on
   the card against the CPU, exactly 10 (standing) or 8 (walking) K1
   launches a tick; as workers beside those checks,
   tests/test_actuated.py's trot bounds (300 ticks, B=64, f32 and B=4 f64)
   and tests/test_estimated_actuated.py's BasicKF bounds (300 ticks, B=64,
   f32) in every robot; then, with no worker running: K7 alone by CUDA
   events around a replayed graph (B in {1, 64, 512, 4096, 16384}, f32 and
   f64) beside its bound, and one plain step at B=64; the CLI's
   `run_actuated` fleet (one Go1 tiled, f32, N=10, 2 x 4, n_sub=80, 0.4
   m/s) at B=64 and B=4096: p50 /
   min / max of 10 ticks after 3 warm-ups, exactly 1 K7 and 8 K1 launches a
   tick; one plain-plant control period at B=64; a profile of one B=64 tick
   split between pre / solve / post; a tick of the actuated step and of the
   estimated one (BasicKF; EKF with a mocap fusion) under
   `set_sync_debug_mode("error")`.

14. the host side (`runtime.hardware_loop`, the CLI; f32, one Go1, the
   loop's horizon 6, 1 AL x 3 iLQR, 50 Hz requested): the operator flows of
   tests/test_hardware_loop.py tick by tick against the peer's plant on the
   card (`peer_step`, 160 substeps a 20 ms tick): B, 25 prime ticks, B, 60
   MPC ticks (KF error after prime < 0.02 m, height within 0.03 m, drift <
   0.02 m/s, Σfz within 10% of mg), and B, prime, B, stand, A at 0.3 m/s, 80
   walking ticks, A, 50 standing ticks at horizon 8, 2 x 3 (walked > 0.2 m,
   upright every tick, the final stand quiet), exactly al x ilqr K1
   launches a tick and one K7 a peer step; beside the flows, a worker
   holding K7 at the loop's shapes (B=1, n_sub 32 and 160) against the plain
   step on the CPU at phase 13's tolerances, and `cli run_hardware`; the
   walk flow's tick of each mode from its own carry in f64, card against
   CPU, at the publish lead 0 and 0.02 (1e-9 of scale); the loop's CUDA
   graphs (the two-tier tick, the estimator and MPC tiers, the peer's
   period) replayed against the eager calls on the walk flow's inputs,
   equal bit for bit, with al x ilqr K1 and K2 and one K7 a replay; the
   warm tick's p50 / min / max with its pull, replayed and eager, alone, and
   replayed beside the loop's peer and servo thread over UDP; the peer's
   host ms a period; the device operations of one replay in a profile (3
   K1, 3 K2) and of one peer period in a fresh process's (1 K7; in the long
   process a trace loses some of a graph's records); a trace that lost
   records is taken again, up to three times; a replay and an eager tick under
   `set_sync_debug_mode("error")`; then, one after another in a fresh
   process with nothing else running, the threaded `run_hardware_loopback`
   (RateLoop threads, seqlock buses, UDP, the peer; graphs replayed) held
   to the JAX tests' own bounds: the two-tier
   stand at the 50 Hz asked (height error < 0.04 m, KF error < 0.03 m,
   drift < 0.05 m/s, MPC overruns at most a fifth of the ticks), the
   three-tier stand (estimator 250 Hz: more than 1.5 updates a tick), the
   async_mpc stand, the pool stand (mechanism), the two-tier walk (> 0.1 m,
   KF error < 0.05 m, > 100 peer periods and servo states); the three-tier
   walk in four fresh processes (estimator >= 150 Hz, each survivor >
   0.1 m; the count upright printed beside the JAX test's bound, 3 of 4)
   and the pool walk at 100 Hz in one;
   every run's K1 and K2 launches al x ilqr a tick call and K7 one a peer
   period;
   and `cli bench_solver --batch 4096` alone.

15. the fleet over `torch.distributed` (`parallel/`), checkpoints and
   `cli run_fleet` (B=4096, f32, horizon 10): standing (2 x 5, in a
   one-rank NCCL group from torchrun's environment) and `--walk 0.3` (2 x 4)
   as processes, each ending on the carry of the unsharded fleet step driven
   here from the same start, bit for bit, its printed totals the step's
   sums; a run of 2 ticks checkpointed and resumed for 2 more ending on the
   unbroken 4-tick run's carry bit for bit; here, the fleet sharded over a
   one-rank NCCL group that `distributed.init` joins at a local address:
   the same carry, its all_reduce calls through NCCL in a traced tick
   (and the NCCL kernels the trace shows, printed); exactly 10 / 8 K1 a
   standing / walking tick.

16. the entry points' CUDA graphs (`utils.graphs.Graphed`, replayed where
   the JAX package jits), each against the eager call of the same library
   function on the same inputs, every output's elements compared (0 may
   differ) and the graph's kernel launches a replay held (al x ilqr of K1
   or K4's fused entry, K2 and K8; one K7 an actuated tick), with its
   warm-up and capture seconds and its pool's bytes: `cli bench_solver`'s
   controller (2 x 5, 8 alphas) at B in {1, 256, 4096, 16384} in f32 and
   B=256 in f64, a second set of inputs replayed too, and the convex one at
   B=4096; chained ticks as the CLI's loops replay them: the standing fleet
   (B=4096, pushed), the walking RTI fleet (B=4096), the actuated fleet and
   its estimated step (B=64), `viz_forces`' one robot, the estimated fleet
   with its noise from a CUDA generator registered with the graph (ten
   replays against ten eager ticks from the same generator state);
   `scaling_report_fleet` at one rank; `solve_scenario`'s falling_cat
   solve, the falling_cat fleet (B=4096, 3 x 25) and `run_closed_loop`'s
   receding tick; one `solve_scenario` call timed as the parent tree ran
   it (eager), as its first call (warm-ups, capture, replay) and as a later
   call with the same arguments (a replay of the graph it keeps), in turns.
   The controller's step and `make_solver`'s solve run once
   under `set_sync_debug_mode("error")`. The CLI's commands bench_solver,
   run_standing (pushed), run_trot, run_actuated (and --kf_type 1) and
   run_scenario (falling_cat, open and closed loop) run in this process,
   each launching K1, K2 and K8 exactly for its graphed calls and the
   capture's warm-ups (an eager command runs no warm-up). The fleet step, the walking tick,
   the convex step and the falling_cat solve are timed eager and graphed in
   turns (p50 / min / max) and traced once each (device ops, busy ms, its
   share of the p50); then B=1 replays under "assoc" and "sweep" in turns at
   N=10 and 20 (2 x 5) and at the hardware tick's N=6 (1 x 3, 12 alphas).
   Phase 15's `cli run_fleet` processes and phase 14's `cli bench_solver`
   replay graphs as well; the closed-loop quality workers walking-f32,
   walking-f64, walking-f32-moved and falling-cat-loop run their ticks
   through the graphed loop.

Then one JSON line describing each kernel (K2 one entry an instantiation:
`line_search`, the quaternion SRB's, and `line_search[<instantiation>]`),
and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

--kernels-only runs phases 1-3 (K2 included), K7 against the plain step and
timed (on the mixed fleet's starting states), phase 12's kernel checks and
the kernels' timings, and for K7 also: builds at 32, 64 and 128 lanes a block
(-DK7_THREADS) and, with --k7-baseline, another source of the kernel with
the same C interface (the previous design), timed in turns at B=64 and 4096,
f32 and f64; and the clocks of each phase of a substep from a
-DK7_PHASE_CLOCKS build at the same shapes. For K2 also (phase_k2_designs):
its build options and, with --k2-baseline, another source of it with the
same C interface (the previous design), held bit for bit against the shipped
build and timed in turns; its launch plans swept; the wrapper's host time by
part; and the clocks of each pass from a -DK2_PHASE_CLOCKS build. For K8
also, with --k8-baseline (phase_k8_designs), other sources of it with the
same C interface (the body before the template over the model, or the
shipped one with another block shape), each held bit for bit against the
shipped build at every checked shape of the instantiations it has and timed
in turns with it, alone and with K1 after it. For K9 also
(phase_k9_designs): its build options (-DK9_UNSTAGED, -DK9_PLAN_OVERRIDE)
and, with --k9-baseline, another source of it with the same C interface
(the parent's), each held bit for bit against the shipped build (xs, λ̄ and
J at K2's checked shapes, B=1 included) and timed in turns at K9_TIMED; its
launch plans swept; each build's SASS counted by opcode. For K10 also
(phase_k10_designs): builds at one, two and four warps a block
(-DK10_WARPS) and, with --k10-baseline, another source of it with the same
C interface (the parent's), each held bit for bit against the shipped build
on every output at K10_CHECKED_B, f32 and f64, on the walks' states, and
timed in turns at B = 1, 256 and 4096; their registers, stack, spill and
blocks an SM, the shipped and the baseline SASS by opcode. For K11 also
(phase_k11_designs): the same, at one, two and four warps a block
(-DK11_WARPS) and with --k11-baseline, on the walks', the estimated and the
standing fleets' states, timed walking and standing. It prints no result
line.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HORIZON = 10
FLEET_SIZES = (256, 4096, 16384)
GO1_WEIGHT_N = 12.84 * 9.81  # the fleet's mean Σfz while standing
LATENCY_TICKS = 10  # timed ticks per backend and row, in two turns of 5


def _sync_time(fn, runs=10, warmup=2):
    """p50 wall seconds of fn() ending in torch.cuda.synchronize()."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _event_time(fn, reps, warmup=3):
    """Mean device seconds of fn() over ``reps`` back-to-back calls, between
    two CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


# Published peaks of one H100 SXM (NVIDIA's data sheet): device memory, and
# arithmetic outside the tensor cores by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def _bound(work, dtype):
    """(least ms the card could take for `work`, "bytes" or "operations"):
    the larger of its bytes over the memory rate and its operations over the
    peak rate of the type."""
    by_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
    by_ops = work["flops"] / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _graph_time(fn, reps):
    """Mean device seconds of fn() over ``reps`` calls captured into one CUDA
    graph and replayed between two CUDA events. The host enqueues nothing
    during the replay, so a kernel shorter than its Python wrapper's call
    (tens of microseconds) is still timed at its own length."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def _enqueue_time(fn, reps=100):
    """Mean host seconds the caller spends in one fn() (no synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return dt


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


# K2's, K8's and K9's launches on each counted path of this process, by
# instantiation (K9's by entry, then instantiation), for the kernels line
K2_LAUNCHES = {}
K8_LAUNCHES = {}
K9_LAUNCHES = {}
# K10's launches on each counted path of this process (path -> launches)
K10_LAUNCHES = {}


def _k10():
    from quaternion_mpc_tpu_torch.kernels import walking_pre as k10

    return k10.walking_pre


def _k10_count(path, n):
    if n:
        K10_LAUNCHES[path] = K10_LAUNCHES.get(path, 0) + n


# K11's launches on each counted path of this process (path -> launches)
K11_LAUNCHES = {}


def _k11():
    from quaternion_mpc_tpu_torch.kernels import srb_post as k11

    return k11.srb_post


def _k11_count(path, n):
    if n:
        K11_LAUNCHES[path] = K11_LAUNCHES.get(path, 0) + n


def _k8():
    """K8's wrapper, whose ``launches`` count its launches."""
    from quaternion_mpc_tpu_torch.kernels import expansions

    return expansions.knot_expansions


def _k9():
    """K9's two wrappers (`rollout`, `price`), whose ``launches`` count
    their launches."""
    from quaternion_mpc_tpu_torch.kernels import rollout

    return rollout.rollout, rollout.price


def _zero_k9():
    for entry in _k9():
        entry.launches = 0


def _k2_count(path, n, instantiation="quat_srb_midpoint", *, k8, k9=None, solves=None):
    """Adds ``n`` K2 launches, as counted on a path of this process, to
    ``path``'s of ``instantiation`` in the kernels line, and ``k8``, K8's
    launches counted on the same run, to the path's K8 launches of the same
    instantiation, after holding them equal: K8 has every model K2 has, and
    both run once an iLQR iteration. ``k9``: K9's (rollout, price) launches
    on the same run (where not given, its wrappers' counts, which the path
    set to 0 with K8's): K9 runs where K2 runs, its rollout once a solve
    (``solves``, where the path knows them) and its pricing al + 1 times a
    solve (the multiplier updates, then the final cost), so that the AL
    iterations (pricings less rollouts) divide K2's al x ilqr; where K2 runs
    not, neither does K9."""
    if k9 is None:
        k9 = tuple(entry.launches for entry in _k9())
    for counts, launched in ((K2_LAUNCHES, n), (K8_LAUNCHES, k8)):
        paths = counts.setdefault(instantiation, {})
        paths[path] = paths.get(path, 0) + launched
    for entry, launched in zip(("rollout", "price"), k9):
        paths = K9_LAUNCHES.setdefault(entry, {}).setdefault(instantiation, {})
        paths[path] = paths.get(path, 0) + launched
    _check(k8 == n, f"{path}: K8 launches {k8}, expected {n} beside {n} of K2's {instantiation}")
    r, p = k9
    if n == 0:
        _check(r == p == 0, f"{path}: K9's (rollout, price) launched {k9} where K2 did not")
        return
    _check(r >= 1 and p > r and n % (p - r) == 0 and (solves is None or r == solves),
           f"{path}: K9's (rollout, price) launches {k9} beside {n} of K2's"
           + ("" if solves is None else f" over {solves} solves")
           + ": expected its rollout once a solve and its pricing al + 1 times")


def _first_pass(prob, spec):
    """The K1 inputs of a problem's first backward pass: expansions along
    the initial rollout (zero multipliers, rho 1, reg 1e-8)."""
    from quaternion_mpc_tpu_torch.solver import fleet

    us = prob.us_init
    dtype, device, batch = us.dtype, us.device, us.shape[-1]
    xs = fleet.open_loop_rollout(spec, prob, us)
    lam = torch.zeros((us.shape[0], prob.cb.shape[-2], batch), dtype=dtype, device=device)
    rho = torch.tensor(1.0, dtype=dtype, device=device)
    exps = fleet.knot_expansions(spec, prob, xs, us, lam, rho)
    lxN, lxxN = fleet.terminal_expansion(spec, xs[-1], prob)
    reg = torch.full((batch,), 1e-8, dtype=dtype, device=device)
    return [t.contiguous() for t in (*exps, lxN, lxxN, reg)]


def _sweep_inputs(batch, dtype, device, horizon=HORIZON):
    """The K1 inputs of the main path's first backward pass on
    standing_batch(batch) over ``horizon`` knots."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.control import quat_mpc

    prob = quat_mpc.build_fleet_problem(
        *examples.standing_batch(batch, horizon, dtype, device), horizon
    )
    return _first_pass(prob, quat_mpc._fleet_spec())


# Tolerances of the sweep against the plain sweep in f64 on the same
# expansions, relative to each output's largest magnitude. f64 kernel vs f64
# plain: 1e-10. f32 kernel and f32 plain, each: 1e-4 for dV1, dV2 and
# max|Qu|; 1e-3 for the gains Ks and ds. Quu carries Rd = 1e-6 on unloaded
# input directions, so its condition number amplifies f32 rounding: the f32
# plain sweep sits up to 2.5e-4 of scale from the f64 sweep on the gains and
# 8.5e-7 on the rest (measured on the CPU at B in {128, 1000, 4096};
# tests/test_torch_fleet.py holds it to these bounds at B=128 and 1000).
_SWEEP_RTOL = {
    torch.float64: dict(Ks=1e-10, ds=1e-10, dV1=1e-10, dV2=1e-10, gmax=1e-10),
    torch.float32: dict(Ks=1e-3, ds=1e-3, dV1=1e-4, dV2=1e-4, gmax=1e-4),
}
_SWEEP_OUTPUTS = ("Ks", "ds", "dV1", "dV2", "gmax")
# The associative-scan pass over the longest tree (N=30), f32: max|Qu| = max|lu
# + Bᵀ·Vx| is a difference 2,000 times smaller than Vx, whose own f32 error
# (1.4e-4 of its scale there, tolerance 1e-3) it inherits through Bᵀ: the f32
# plain version itself sits 1.4e-4 of max|Qu|'s scale from f64 (the "plain ...
# vs plain f64" line of the same shape shows it), so kernel and plain are held
# to 3e-4 there. Every shorter horizon keeps 1e-4.
_LONG_TREE_F32_RTOL = dict(_SWEEP_RTOL[torch.float32], gmax=3e-4)


def _hold(got, want, dtype, what, rtol=None):
    """Check got against want (each output to ``rtol``, by default
    _SWEEP_RTOL[dtype], of want's largest magnitude); returns (per-output
    "err/scale" strings, max abs err)."""
    rtol = rtol or _SWEEP_RTOL[dtype]
    parts, worst = [], 0.0
    for name, g, w in zip(_SWEEP_OUTPUTS, got, want):
        err = (g.double() - w.double()).abs().max().item()
        scale = w.abs().max().item()
        tol = rtol[name] * scale
        _check(
            bool(torch.isfinite(g).all()) and err <= tol,
            f"{what} {name}: max|err| {err:.3e} > {tol:.3e}",
        )
        parts.append(f"{name} {err:.2e}/{scale:.2e}")
        worst = max(worst, err)
    return ", ".join(parts), worst


# The shapes K1 is held to its plain version at: one warp, a ragged single
# tile, a ragged last tile, full tiles, and many tiles with one scenario over.
K1_CHECKED_B = (1, 7, 1000, 4096, 16385)
# N -> batches. N = 15 and 30 are the horizons of the single problems that
# are 12 x 12 themselves (spider_dog; the convex fixture, alone and B=256);
# N = 6 and 8 the hardware loop's tick (1 x 3) and its sync walk flow (2 x 3),
# both B=1.
K1_CHECKED = {HORIZON: K1_CHECKED_B, 20: K1_CHECKED_B, 15: (1, 7, 256), 30: (1, 7, 256),
              6: (1, 7), 8: (1, 7)}


def phase_kernel_vs_plain(device):
    """K1 against the plain sweep at K1_CHECKED's (N, B). f64: kernel
    vs plain, same inputs. f32: the kernel and the f32 plain sweep, each
    against the plain sweep in f64 on the same (f32) expansions. Returns the
    f32 kernel's max abs error against that f64 sweep at N=10, B=4096."""
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    worst_f32 = 0.0
    for dtype in (torch.float32, torch.float64):
        for horizon, batches in K1_CHECKED.items():
            for batch in batches:
                args = _sweep_inputs(batch, dtype, device, horizon)
                before = rs.riccati_sweep.launches
                got = rs.riccati_sweep(*args)
                torch.cuda.synchronize()
                _check(rs.riccati_sweep.launches == before + 1, "riccati_sweep did not launch")
                want = rs.riccati_sweep_ref(*(t.double() for t in args))
                tag = f"riccati_sweep {str(dtype)[6:]} N={horizon} B={batch}"
                line, worst = _hold(got, want, dtype, tag)
                print(f"[kernel] {tag} vs plain f64, max|err|/scale: {line}")
                if dtype == torch.float32:
                    line, _ = _hold(rs.riccati_sweep_ref(*args), want, dtype, f"plain {tag}")
                    print(f"[kernel] plain sweep float32 N={horizon} B={batch} vs plain f64, "
                          f"max|err|/scale: {line}")
                    if (horizon, batch) == (HORIZON, 4096):
                        worst_f32 = worst
                del args, got, want
    return worst_f32


# K4's checked shapes: (problem, N, batches). The first batch of the first
# two, and B=256 of the fixture, are also the timed ones.
K4_CHECKED = (("fixture", 20, (1, 7, 256)), ("standing", HORIZON, (1, 7)),
              ("standing", 30, (1, 7, 256)))
K4_TIMED = ("fixture N=20 B=1", "fixture N=20 B=256", f"standing N={HORIZON} B=1")


def _scan_cases(dtype, device, only=None):
    """(tag, K1's and the fused entry's inputs, the scan's inputs) of K4's
    shapes (K4_CHECKED, or the tags in ``only``): the golden fixture at N=20,
    a standing robot (standing_batch) at N=10, and the longest tree, N=30."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.control import quat_mpc
    from quaternion_mpc_tpu_torch.solver.parallel_riccati import value_elements

    spec = quat_mpc._fleet_spec()
    cases = []
    for name, horizon, batches in K4_CHECKED:
        for b in batches:
            tag = f"{name} N={horizon} B={b}"
            if only is not None and tag not in only:
                continue
            if name == "fixture":
                prob = examples.fixture_fleet_problem(b, dtype, device)[0]
            else:
                prob = quat_mpc.build_fleet_problem(
                    *examples.standing_batch(b, horizon, dtype, device), horizon)
            sweep_args = _first_pass(prob, spec)
            elems = [e.contiguous() for e in value_elements(*sweep_args)]
            cases.append((tag, sweep_args, elems))
    return cases


# K4 against the plain scan in f64 on the same elements, relative to each
# output's largest magnitude: f64 kernel vs f64 plain 1e-10 (the same tree,
# rounding only). f32 kernel and f32 plain scan, each against the f64 plain
# scan: 1e-3. The elements inherit the ill-conditioned Quu (Rd = 1e-6), and
# the f32 plain scan sits up to 1.7e-4 of scale from f64 on these shapes
# (measured on the CPU and recorded by
# tests/test_torch_parallel_riccati.py::test_f32_scan_spread_from_f64).
_SCAN_RTOL = {torch.float64: 1e-10, torch.float32: 1e-3}


def _hold_scan(got, want, dtype, what):
    parts, worst = [], 0.0
    for name, g, w in zip(("J", "eta"), got, want):
        err = (g.double() - w.double()).abs().max().item()
        scale = w.abs().max().item()
        tol = _SCAN_RTOL[dtype] * scale
        _check(bool(torch.isfinite(g).all()) and err <= tol,
               f"{what} {name}: max|err| {err:.3e} > {tol:.3e}")
        parts.append(f"{name} {err:.2e}/{scale:.2e}")
        worst = max(worst, err)
    return ", ".join(parts), worst


def phase_scan_vs_plain(device):
    """K4's two entries against their plain versions at K4_CHECKED. f64:
    kernel vs plain, same inputs. f32: the kernel and the f32 plain version,
    each against the plain version in f64 on the same (f32) inputs; the
    fused entry to the sweep's tolerances (_SWEEP_RTOL; max|Qu| of the
    longest tree in f32 to _LONG_TREE_F32_RTOL). Returns the f32 kernels'
    largest max abs errors against f64, (scan, fused)."""
    from quaternion_mpc_tpu_torch.kernels import assoc_scan as k4

    entries = (("assoc_scan", k4.assoc_scan, k4.assoc_scan_ref, _hold_scan),
               ("assoc_backward", k4.assoc_backward, k4.assoc_backward_ref, _hold))
    worst_f32 = {name: 0.0 for name, *_ in entries}
    for dtype in (torch.float32, torch.float64):
        for case, sweep_args, elems in _scan_cases(dtype, device):
            long_f32 = dtype == torch.float32 and elems[0].shape[0] == 31
            for name, kernel, plain, hold in entries:
                args = elems if name == "assoc_scan" else sweep_args
                rtol = ({"rtol": _LONG_TREE_F32_RTOL}
                        if long_f32 and name == "assoc_backward" else {})
                before = kernel.launches
                got = kernel(*args)
                torch.cuda.synchronize()
                _check(kernel.launches == before + 1, f"{name} did not launch")
                want = plain(*(t.double() for t in args))
                tag = f"{name} {str(dtype)[6:]} {case}"
                line, worst = hold(got, want, dtype, tag, **rtol)
                print(f"[kernel] {tag} vs plain f64, max|err|/scale: {line}")
                if dtype == torch.float32:
                    line, _ = hold(plain(*args), want, dtype, f"plain {tag}", **rtol)
                    print(f"[kernel] plain {tag} vs plain f64, max|err|/scale: {line}")
                    worst_f32[name] = max(worst_f32[name], worst)
    return worst_f32["assoc_scan"], worst_f32["assoc_backward"]


# K2's checked shapes: (problem, N, alphas, batches). The quaternion SRB: the
# fleet step's (N=10, 8 alphas: one warp, 8 lanes, a ragged block, many
# blocks), the hardware loop's ticks (N=6 and 8, 12 alphas: 16 lanes a
# scenario), the golden fixture's (N=20, leaves shared along B) and the
# humanoid's (two feet). The Euler SRB: the convex fleet's (midpoint rule,
# N=10, 8 alphas) and the golden convex fixture's (forward Euler, N=30,
# leaves shared along B; one problem and the B=256 fleet of phase 12's
# workers). The attitude model: the falling_cat fleet's (N=40, 12 alphas).
K2_CHECKED = (("standing", HORIZON, 8, (1, 7, 4096)), ("standing", 6, 12, (1, 7)),
              ("standing", 8, 12, (1,)), ("fixture", 20, 12, (1, 256)),
              ("humanoid", 20, 12, (1, 7)), ("convex", HORIZON, 8, (1, 7, 4096)),
              ("convex_fixture", 30, 12, (1, 256)), ("falling_cat", 40, 12, (1, 7, 4096)))
# The instantiation of each problem of K2's (kernels/line_search.INSTANTIATIONS)
K2_MODEL = {"standing": "quat_srb_midpoint", "fixture": "quat_srb_midpoint",
            "humanoid": "quat_srb_midpoint", "convex": "euler_srb_midpoint",
            "convex_fixture": "euler_srb_euler", "falling_cat": "attitude_midpoint"}
# K2 alone: (dtype, problem, N, alphas, B); the first is the kernels line's,
# then the other instantiations' on their paths' shapes (K2_MAIN_OF)
K2_TIMED = ((torch.float32, "standing", HORIZON, 8, 4096), (torch.float32, "standing", 6, 12, 1),
            (torch.float32, "standing", 8, 12, 1), (torch.float32, "standing", HORIZON, 8, 16384),
            (torch.float64, "standing", HORIZON, 8, 4096),
            (torch.float32, "convex", HORIZON, 8, 4096), (torch.float64, "convex", HORIZON, 8, 256),
            (torch.float64, "convex_fixture", 30, 12, 256),
            (torch.float64, "convex_fixture", 30, 12, 1),
            (torch.float32, "falling_cat", 40, 12, 4096),
            (torch.float64, "falling_cat", 40, 12, 4096), (torch.float64, "falling_cat", 40, 12, 1))
# K2 against its plain version on the same inputs: f64 to 1e-10 of scale; f32
# to 1e-4 (J_k of max(|J_k|, |J|), xs and us of their largest magnitude, in
# the scenarios whose selected alpha both sides agree on; a flip must be a
# margin case: kernels/line_search.compare).
K2_RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}
K2_MAIN = "f32 N=10 B=4096 K=8"  # the kernels line's shape, K2_TIMED's first
# each instantiation's shape in the kernels line: its main path's (the convex
# fleet's f32 B=4096, the convex fixture's f64 B=256, the falling_cat fleet's
# f32 B=4096), by K2_TIMED's tags
K2_MAIN_OF = {"quat_srb_midpoint": K2_MAIN,
              "euler_srb_midpoint": "convex f32 N=10 B=4096 K=8",
              "euler_srb_euler": "convex_fixture f64 N=30 B=256 K=12",
              "attitude_midpoint": "falling_cat f32 N=40 B=4096 K=12"}


def _k2_hard_case(dtype, device):
    """The fleet step's problem at B=7 with what a line search has to get
    right: a first "alpha" so large that every rollout overflows to Inf /
    NaN (never taken), a scenario that accepts no alpha (1), done scenarios
    (2, 4), per-knot w and cb (feet lifted at random knots) with a terminal
    weight Qdf, and a weight row shared by the fleet."""
    from quaternion_mpc_tpu_torch import examples

    spec, prob, _ = examples.line_search_case("standing", 7, dtype, device, HORIZON, 12)
    N, B = prob.us_init.shape[0], prob.us_init.shape[-1]
    rng = np.random.default_rng(3)
    cb = prob.cb[None].expand(N + 1, *prob.cb.shape).clone()
    cb[:, 4::6][torch.from_numpy(rng.random((N + 1, 4, B)) < 0.3).to(device)] = 0.0
    prob = prob._replace(w=torch.from_numpy(1.0 + rng.random((N + 1, B))).to(device, dtype),
                         cb=cb, Qdf=10.0 * prob.Qd, Qd=prob.Qd[:, :1].contiguous())
    kw = examples.line_search_inputs(spec, prob, 12)
    huge = torch.full((1,), 1e30 if dtype == torch.float32 else 1e160, dtype=dtype, device=device)
    kw["alphas"] = torch.cat([huge, kw["alphas"][:-1]])
    kw["J"][1] = -1e3
    kw["done"][[2, 4]] = True
    return spec, prob, kw


def _k2_runaway_case(dtype, device):
    """The falling_cat fleet's problem at B=7 (N=40, 12 alphas) with a first
    "alpha" so large that every rollout runs away to Inf / NaN (the torque
    enters the gyroscopic term and the quaternion's rate; never taken), a
    scenario that accepts no alpha (1) and done scenarios (2, 4)."""
    from quaternion_mpc_tpu_torch import examples

    spec, prob, kw = examples.line_search_case("falling_cat", 7, dtype, device, 40, 12)
    huge = torch.full((1,), 1e30 if dtype == torch.float32 else 1e160, dtype=dtype, device=device)
    kw["alphas"] = torch.cat([huge, kw["alphas"][:-1]])
    kw["J"][1] = -1e3
    kw["done"][[2, 4]] = True
    return spec, prob, kw


def _k2_shape(name, dtype, horizon, n_alphas, batch):
    """A K2 shape's tag: "f32 N=10 B=4096 K=8" for the quaternion fleet's
    problem, the problem's name in front for the others."""
    tag = f"{_shape_tag(dtype, horizon, batch)} K={n_alphas}"
    return tag if name == "standing" else f"{name} {tag}"


def _k2_cases(dtype, device):
    """(tag, problem, (spec, prob, inputs)) of every K2_CHECKED shape in
    ``dtype``, then the hard case and the runaway case."""
    from quaternion_mpc_tpu_torch import examples

    name32 = "f32" if dtype == torch.float32 else "f64"
    for name, horizon, n_alphas, batches in K2_CHECKED:
        for batch in batches:
            yield (_k2_shape(name, dtype, horizon, n_alphas, batch), name,
                   examples.line_search_case(name, batch, dtype, device, horizon, n_alphas))
    yield (f"{name32} hard case B=7 (Inf / NaN alpha, none accepted, done, per-knot w and cb, "
           f"Qdf)", "standing", _k2_hard_case(dtype, device))
    yield (f"{name32} falling_cat runaway case B=7 (Inf / NaN alpha, none accepted, done)",
           "falling_cat", _k2_runaway_case(dtype, device))


def _hold_line_search(spec, prob, kw, tag):
    """K2 once on the card against its plain version on the same inputs
    (K2_RTOL); returns kernels.line_search.compare's dict with the flips'
    count and the largest absolute error of J_k, xs, us and J."""
    from quaternion_mpc_tpu_torch.kernels import line_search as k2

    dtype = kw["xs"].dtype
    before = k2.line_search.launches
    got = k2.line_search(spec, prob, **kw, with_costs=True)
    torch.cuda.synchronize()
    _check(k2.line_search.launches == before + 1, "line_search did not launch")
    want = k2.line_search_ref(spec, prob, **kw, with_costs=True)
    held = k2.conditioned(spec, prob, kw)
    res = k2.compare(got, want, kw["dV1"], kw["dV2"], kw["alphas"], K2_RTOL[dtype], held=held)
    rtol = K2_RTOL[dtype]
    _check(res["nonfinite_same"], f"{tag}: the costs are non-finite in other places")
    _check(all(res[k] <= rtol for k in ("costs_err", "xs_err", "us_err", "J_err")),
           f"{tag}: outside {rtol} of scale: {res}")
    _check(res["decisions_same"] and res["margin_cases"]
           and (dtype == torch.float32 or not res["flips"]),
           f"{tag}: decisions differ outside the margin cases: {res}")
    costs, scenarios = (h.to(want[6].device) for h in held)
    scenarios[res["flips"]] = False  # a flip's outputs differ by design
    finite = torch.isfinite(want[6]) & costs & scenarios[None, :]
    res["max_abs_err"] = max(
        float(torch.where(finite, (got[6] - want[6]).abs(), 0.0).max()),
        *(float(torch.where(scenarios, (g - w).abs(), 0.0).max())
          for g, w in zip(got[:4], want[:4])))
    print(f"[kernel] line_search {tag}{' J priced' if kw['J'] is None else ''} vs plain: J_k "
          f"{res['costs_err']:.2e}, xs "
          f"{res['xs_err']:.2e}, us {res['us_err']:.2e}, J {res['J_err']:.2e} of scale (tol "
          f"{rtol}); {len(res['flips'])} of {kw['dV1'].shape[0]} scenarios flipped"
          + (f" (each a margin case, {res['runaway_cases']} at a runaway rollout)"
             if res["flips"] else "")
          + (f"; runaway rollouts set aside: {res['set_aside']} costs, "
             f"{res['set_aside_scenarios']} scenarios whose selected rollout runs away"
             if res["set_aside"] or res["set_aside_scenarios"] else ""))
    return res


def phase_line_search_vs_plain(device):
    """K2 against line_search_ref at K2_CHECKED's shapes, f32 and f64, on the
    hard case (_k2_hard_case) and on the runaway case (_k2_runaway_case),
    each with J given and with J None (priced by the kernel); in f32 also the
    f32 plain version against the f64 one at each instantiation's main
    shape, for the record. Returns ({instantiation: the f32 kernel's max abs
    error at its main shape (K2_MAIN_OF)}, flips in f32 over all checks, and
    the checks' count)."""
    from quaternion_mpc_tpu_torch.kernels import line_search as k2

    worst, flips, checks = {}, 0, 0
    for dtype in (torch.float32, torch.float64):
        for tag, name, (spec, prob, kw) in _k2_cases(dtype, device):
            # J given, and J None: the kernel prices xs_bar and us_bar itself (an AL
            # iteration's first line search)
            for given in (True, False):
                res = _hold_line_search(spec, prob, kw if given else {**kw, "J": None}, tag)
                flips, checks = flips + len(res["flips"]), checks + 1
            if tag != K2_MAIN_OF[K2_MODEL[name]]:
                continue
            worst[K2_MODEL[name]] = res["max_abs_err"]
            if dtype == torch.float32:
                up = lambda t: t.double() if t.is_floating_point() else t
                prob64 = type(prob)(*(type(x)(*map(up, x)) if isinstance(x, tuple)
                                      else up(x) if isinstance(x, torch.Tensor) else x
                                      for x in prob))
                p32 = k2.line_search_ref(spec, prob, **kw, with_costs=True)[6].double()
                p64 = k2.line_search_ref(spec, prob64, **{k: up(v) for k, v in kw.items()},
                                         with_costs=True)[6]
                scale = torch.maximum(p64.abs(), kw["J"].double().abs()[None])
                print(f"[kernel] (for the record) the f32 plain line search against the f64 "
                      f"one on the same inputs, {tag}: J_k "
                      f"{float(((p32 - p64).abs() / scale).max()):.2e} of max(|J_k|, |J|)")
    print(f"[kernel] line_search: {checks} checks, {flips} f32 flips in all (each a margin case)")
    # K2's inputs come from a first backward pass, whose expansions are K8's
    # on every model K2 has: the falling_cat fleet's shape again with the
    # plain expansions behind its gains (an untagged spec), as K2's check was
    # fed before K8 had the attitude model, for the record of the runaway
    # rollouts set aside
    from quaternion_mpc_tpu_torch import examples

    shape = K2_MAIN_OF["attitude_midpoint"]
    spec, prob, _ = examples.line_search_case("falling_cat", 4096, torch.float32, device, 40, 12)
    kw = examples.line_search_inputs(spec._replace(expansions=None), prob, 12)
    for given in (True, False):
        _hold_line_search(spec, prob, kw if given else {**kw, "J": None},
                          f"{shape} (its gains through the plain expansions)")
    return worst, flips, checks


def phase_line_search_timing(device):
    """K2 alone at K2_TIMED: CUDA events around a replayed graph of 50
    launches, the host's time in one call of the wrapper, the bound of the
    function (`kernels.line_search.work` over the card's peaks) and the
    plain version's time (eager launches). Returns {tag: {"ms",
    "host_enqueue_ms", "plain_ms", "bound_ms", "bound_by"}}."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.kernels import line_search as k2

    by_shape = {}
    for dtype, name, horizon, n_alphas, batch in K2_TIMED:
        spec, prob, kw = examples.line_search_case(name, batch, dtype, device, horizon, n_alphas)
        launch = lambda: k2.line_search(spec, prob, **kw)
        ms = _graph_time(launch, reps=50) * 1e3
        host_ms = _enqueue_time(launch) * 1e3
        plain_ms = _event_time(lambda: k2.line_search_ref(spec, prob, **kw), reps=3) * 1e3
        bound_ms, bound_by = _bound(k2.work(spec, prob, **kw), dtype)
        tag = _k2_shape(name, dtype, horizon, n_alphas, batch)
        by_shape[tag] = {"ms": ms, "host_enqueue_ms": host_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"[timing] K2 line_search {tag}: kernel {ms:.4f} ms (graph replay; host "
              f"{host_ms:.4f} ms a call), bound {bound_ms:.5f} ms by {bound_by} "
              f"({100 * bound_ms / ms:.2f}% of it reached), plain {plain_ms:.3f} ms")
    return by_shape


# K8's checked shapes of the quaternion SRB: (problem, N, batches, leaves).
# The fleet step's (N=10: one scenario, ragged tiles of 32, many tiles), the
# hardware loop's ticks (N=6 and 8, B=1), the golden fixture's (N=20, leaves
# shared along B), the humanoid's (two feet) and the fleet's with per-knot
# leaves (w and cb per knot, a terminal weight Qdf, one weight row for the
# fleet).
K8_CHECKED = (("standing", HORIZON, (1, 7, 31, 33, 130, 4096), "per scenario"),
              ("standing", 6, (1,), "per scenario"), ("standing", 8, (1,), "per scenario"),
              ("fixture", 20, (256,), "shared"), ("humanoid", 20, (33,), "per scenario"),
              ("standing", HORIZON, (4096,), "per knot"))
# K8's other instantiations' checked shapes: (dtype, problem, N, B, inputs).
# Each model's paths' (the convex fleet's f32 N=10 B=4096 and f64 B=256; the
# convex fixture's f64 N=30 at B=256 and B=1, forward Euler, leaves shared
# along B; the falling_cat fleet's f32 N=40 B=4096 and f64 B=1), a ragged
# tile of each, the falling_cat fleet's iterate after 1 x 4 iLQR iterations
# ("iterate"), its runaway starts included, and its first expansions with
# starts blown up so that values overflow ("blown": `_k8_blown_inputs`), in
# f32 and f64.
K8_MODELS_CHECKED = (
    (torch.float32, "convex", HORIZON, 4096, "first"), (torch.float32, "convex", HORIZON, 7, "first"),
    (torch.float64, "convex", HORIZON, 256, "first"),
    (torch.float64, "convex_fixture", 30, 256, "first"),
    (torch.float64, "convex_fixture", 30, 1, "first"),
    (torch.float32, "convex_fixture", 30, 33, "first"),
    (torch.float32, "falling_cat", 40, 4096, "first"), (torch.float32, "falling_cat", 40, 7, "first"),
    (torch.float64, "falling_cat", 40, 1, "first"), (torch.float64, "falling_cat", 40, 256, "first"),
    (torch.float32, "falling_cat", 40, 4096, "iterate"),
    (torch.float64, "falling_cat", 40, 4096, "iterate"),
    (torch.float32, "falling_cat", 40, 7, "blown"), (torch.float64, "falling_cat", 40, 7, "blown"))
# The instantiation of each problem of K8's (kernels/expansions.INSTANTIATIONS)
K8_MODEL = {"standing": "quat_srb_midpoint", "fixture": "quat_srb_midpoint",
            "humanoid": "quat_srb_midpoint", "convex": "euler_srb_midpoint",
            "convex_fixture": "euler_srb_euler", "falling_cat": "attitude_midpoint"}
# K8 against its plain version on the same inputs, each output relative to
# its largest magnitude (the other models: to each scenario's largest
# magnitude of the output, so that a runaway start's does not hide the
# others'): f64 1e-12; f32 1e-5. At B > 1 the quaternion and the Euler SRB's
# instantiations compute what PyTorch computes on the card, operation for
# operation and in its order of summation (csrc/expansions.cu), so there
# every element must be equal; at B = 1 PyTorch reduces a sum whose terms
# lie next to each other in memory by another scheme, and the last bits may
# differ. The attitude model's plain Jacobian is torch.func.jacfwd's: held
# to the tolerance, with as many non-finite elements in each output as the
# plain version's.
K8_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# K8 alone: (dtype, problem, N, B); the first is the kernels line's (the fleet
# step's), then the other instantiations' on their paths' shapes (K8_MAIN_OF)
K8_TIMED = ((torch.float32, "standing", HORIZON, 4096), (torch.float32, "standing", 6, 1),
            (torch.float32, "standing", HORIZON, 16384), (torch.float64, "standing", HORIZON, 256),
            (torch.float64, "standing", HORIZON, 4096),
            (torch.float32, "convex", HORIZON, 4096), (torch.float64, "convex", HORIZON, 256),
            (torch.float64, "convex_fixture", 30, 256), (torch.float64, "convex_fixture", 30, 1),
            (torch.float32, "falling_cat", 40, 4096), (torch.float64, "falling_cat", 40, 1))
# each instantiation's shape in the kernels line, by K8_TIMED's tags
K8_MAIN_OF = {"quat_srb_midpoint": f"float32 N={HORIZON} B=4096",
              "euler_srb_midpoint": f"convex float32 N={HORIZON} B=4096",
              "euler_srb_euler": "convex_fixture float64 N=30 B=256",
              "attitude_midpoint": "falling_cat float32 N=40 B=4096"}


def _k8_inputs(name, horizon, batch, dtype, device, leaves="per scenario"):
    """(spec, prob, xs, us, lam, rho): a problem's first expansions, along
    the open-loop rollout of us_init, with multipliers drawn (half zero, the
    rest up to 200: some rows active, some not) at penalty 1. ``leaves``
    "per knot": w and cb per knot (feet lifted at random knots), Qdf = 10·Qd,
    one Qd row for the fleet."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.solver import fleet

    spec, prob, _ = examples.line_search_case(name, batch, dtype, device, horizon, 8)
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a, dtype=dtype).to(device)
    if leaves == "per knot":
        N = horizon
        cb = prob.cb[None].expand(N + 1, *prob.cb.shape).clone() if prob.cb.dim() == 2 \
            else prob.cb.clone()
        cb[:, 4::6][t(rng.random((N + 1, 4, batch))) < 0.3] = 0.0
        prob = prob._replace(w=t(1.0 + rng.random((N + 1, batch))), cb=cb, Qdf=10.0 * prob.Qd,
                             Qd=prob.Qd[:, :1].contiguous())
    us = prob.us_init
    nc = prob.cb.shape[-2]
    lam = t(200.0 * rng.random((horizon, nc, batch)) * (rng.random((horizon, nc, batch)) < 0.5))
    xs = fleet.open_loop_rollout(spec, prob, us)
    return spec, prob, xs, us, lam, torch.ones((), dtype=dtype, device=device)


def _k8_iterate_inputs(batch, dtype, device, iterations=4):
    """The falling_cat fleet's (`examples.falling_cat_fleet`, N=40) expansions
    at its iterate after 1 AL x ``iterations`` iLQR iterations (xs, us and
    the multipliers there, penalty 1): the steep starts that run away have
    done so by then (|q| far from 1)."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.solver import al_ilqr, fleet

    spec, prob, opts = examples.falling_cat_fleet(batch, dtype, device, seed=0)
    spec, prob = al_ilqr.fleet_spec(spec), al_ilqr.lift_problem(prob)
    opts = opts._replace(al_iterations=1, ilqr_iterations=iterations)
    sol = fleet.make_fleet_solver(spec, opts, backend="sweep")(prob)
    return spec, prob, sol.xs, sol.us, sol.lam, torch.ones((), dtype=dtype, device=device)


def _k8_blown_inputs(dtype, device):
    """The falling_cat fleet's first expansions (`_k8_inputs`, N=40, B=7)
    with runaway states put in: scenario 1's quaternion blown up at knots
    3-5 far enough that the expansions' products overflow, scenario 4's
    first state Inf, scenario 5's a NaN (as
    tests/test_torch_expansions_emulation.py puts them)."""
    spec, prob, xs, us, lam, rho = _k8_inputs("falling_cat", 40, 7, dtype, device)
    xs = xs.clone()
    xs[3:6, 0:4, 1] *= 1e13 if dtype == torch.float32 else 1e105
    xs[0, 5, 4] = float("inf")
    xs[2, 1, 5] = float("nan")
    return spec, prob, xs, us, lam, rho


def _k8_differ(got, want, per_scenario):
    """(the largest relative error over the outputs, each relative to its
    largest magnitude or, with ``per_scenario``, to each scenario's; those
    errors by output; the largest |difference|; each output's non-finite
    elements (K8's, the plain version's); whether they lie in the same
    places), over the elements finite on both sides."""
    errs, abs_err, counts, same = [], 0.0, [], True
    for g, w in zip(got, want):
        _check(g.shape == w.shape, f"K8: an output of shape {tuple(g.shape)}, plain "
                                   f"{tuple(w.shape)}")
        bad_g, bad_w = ~torch.isfinite(g), ~torch.isfinite(w)
        counts.append((int(bad_g.sum()), int(bad_w.sum())))
        same = same and bool(torch.equal(bad_g, bad_w))
        d = torch.where(bad_g | bad_w, 0.0, (g - w).abs())
        mag = torch.where(bad_w, 0.0, w.abs())
        if per_scenario:
            err = d.flatten(0, -2).amax(0) / mag.flatten(0, -2).amax(0).clamp_min(1e-300)
        else:
            err = d.max() / mag.max().clamp_min(1e-300)
        errs.append(float(err.max()))
        abs_err = max(abs_err, float(d.max()))
    return max(errs), errs, abs_err, counts, same


def phase_expansions_vs_plain(device):
    """K8 against knot_expansions_ref, f32 and f64, every element of the
    eight outputs (they start uninitialised): the quaternion SRB at
    K8_CHECKED's shapes (each output held relative to its largest magnitude,
    K8_RTOL, finite, and at B > 1 equal bit for bit), the other
    instantiations at K8_MODELS_CHECKED's (relative to each scenario's
    largest magnitude; the Euler SRB's at B > 1 equal bit for bit; each
    output with as many non-finite elements as the plain version's, some at
    the blown-up starts). Returns
    ({"f32", "f64"}: the largest relative error over all shapes, and
    {instantiation: the kernel's max abs error at its kernels-line shape,
    K8_MAIN_OF})."""
    from quaternion_mpc_tpu_torch.kernels import expansions as k8

    worst, main_abs = {}, {}
    cases = [(dtype, name, horizon, batch, leaves) for dtype in (torch.float32, torch.float64)
             for name, horizon, batches, leaves in K8_CHECKED for batch in batches]
    for dtype, name, horizon, batch, leaves in cases + list(K8_MODELS_CHECKED):
        tname, inst = str(dtype)[6:], K8_MODEL[name]
        if leaves == "iterate":
            args = _k8_iterate_inputs(batch, dtype, device)
        elif leaves == "blown":
            args = _k8_blown_inputs(dtype, device)
        else:
            args = _k8_inputs(name, horizon, batch, dtype, device,
                              "per scenario" if leaves == "first" else leaves)
        before = k8.knot_expansions.launches
        got = k8.knot_expansions(*args)
        torch.cuda.synchronize()
        _check(k8.knot_expansions.launches == before + 1, "knot_expansions did not launch")
        want = k8.knot_expansions_ref(*args)
        quat = inst == "quat_srb_midpoint"
        err, errs, abs_err, counts, same = _k8_differ(got, want, per_scenario=not quat)
        tag = f"{tname} {name} N={horizon} B={batch} " + (
            f"leaves {leaves}" if quat else "after 1 x 4 iterations" if leaves == "iterate"
            else "starts blown up" if leaves == "blown" else "first iteration")
        nonfinite = sum(c[1] for c in counts)
        print(f"[kernel] expansions[{inst}] {tag} vs plain: max|err|/scale {err:.2e} (tol "
              f"{K8_RTOL[dtype]:g}{'' if quat else ' of each scenario'}; by output "
              f"{', '.join(f'{e:.1e}' for e in errs)}), max|err| {abs_err:.3e}"
              + (f"; non-finite elements by output (K8 / plain) "
                 f"{', '.join(f'{a}/{b}' for a, b in counts)}, in the same places: {same}"
                 if nonfinite or any(c[0] for c in counts) else ""))
        _check(err <= K8_RTOL[dtype], f"K8 {inst} {tag}: {err:.3e} of scale")
        _check(all(a == b for a, b in counts) and (nonfinite == 0 or not quat)
               and (nonfinite > 0 or leaves != "blown"),
               f"K8 {inst} {tag}: non-finite elements {counts} (K8, plain)")
        _check(batch == 1 or inst == "attitude_midpoint" or abs_err == 0.0,
               f"K8 {inst} {tag}: max|err| {abs_err:.3e}, where PyTorch's own operations give "
               f"the same bits")
        worst[tname] = max(worst.get(tname, 0.0), err)
        if leaves in ("first", "per scenario") and _k8_shape(dtype, horizon, batch, name) \
                == K8_MAIN_OF[inst]:
            main_abs[inst] = abs_err
        del args, got, want
    return worst, main_abs


def _k8_shape(dtype, horizon, batch, name="standing"):
    """A K8 shape's tag: "f32 N=10 B=4096" for the quaternion fleet's
    problem, the problem's name in front for the others."""
    tag = f"{str(dtype)[6:]} N={horizon} B={batch}"
    return tag if K8_MODEL[name] == "quat_srb_midpoint" else f"{name} {tag}"


def _k8_registers(kbuild, lib):
    """K8's registers a thread by instantiation, as ptxas reported them."""
    out = {}
    for k in kbuild.ptxas_report(lib):
        inst, dtype, n_feet = _k8_kernel(k["name"])
        out[f"{inst} {dtype} n_feet={n_feet}"] = k["registers"]
    return out


def _k8_kernel(name):
    """(instantiation, dtype, feet) of a K8 kernel's mangled name."""
    m = re.search(r"expansions_kernelI([fd]).*?(QuatSrbMidpoint|EulerSrb|AttitudeMidpoint)"
                  r"(?:ILi(\d)E(?:Lb([01])E)?)?", name)
    inst = {"QuatSrbMidpoint": "quat_srb_midpoint", "AttitudeMidpoint": "attitude_midpoint",
            "EulerSrb": "euler_srb_euler" if m[4] == "1" else "euler_srb_midpoint"}[m[2]]
    return inst, "float32" if m[1] == "f" else "float64", int(m[3] or 1)


def phase_expansions_timing(device):
    """K8 alone at K8_TIMED: CUDA events around a replayed graph of 50
    launches, the host's time in one call of the wrapper, the bound of the
    function (`kernels.expansions.work` over the card's peaks) and the plain
    version's time (eager launches, CUDA events). Returns {tag: {"ms",
    "host_enqueue_ms", "plain_ms", "bound_ms", "bound_by"}}."""
    from quaternion_mpc_tpu_torch.kernels import expansions as k8

    by_shape = {}
    for dtype, name, horizon, batch in K8_TIMED:
        args = _k8_inputs(name, horizon, batch, dtype, device)
        launch = lambda: k8.knot_expansions(*args)
        ms = _graph_time(launch, reps=50) * 1e3
        host_ms = _enqueue_time(launch) * 1e3
        plain_ms = _event_time(lambda: k8.knot_expansions_ref(*args), reps=5) * 1e3
        bound_ms, bound_by = _bound(k8.work(*args), dtype)
        tag = _k8_shape(dtype, horizon, batch, name)
        by_shape[tag] = {"ms": ms, "host_enqueue_ms": host_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"[timing] K8 expansions[{K8_MODEL[name]}] {tag}: kernel {ms:.4f} ms (graph "
              f"replay; host {host_ms:.4f} ms a call), bound {bound_ms:.5f} ms by {bound_by} "
              f"({100 * bound_ms / ms:.2f}% of it reached), plain {plain_ms:.3f} ms")
    return by_shape


# K9 (`kernels.rollout`: the solve's open-loop rollout and its AL pricing)
# against its plain versions at K2's checked shapes and models (K2_CHECKED,
# the hard case and the runaway case), f32 and f64: each path's us_init
# rolled out, the rollout priced (J and λ̄ together, the multiplier update's
# λ̄ alone, the final cost: no λ at ρ = 1e-30) and a mid-solve iterate (the
# plain line search's output after one iteration) priced. At B > 1 xs and λ̄
# must equal the plain version's bit for bit (NaN matching NaN), J within
# K9_RTOL of max(|J|, 1) (its elements that differ counted); at B = 1 (where
# PyTorch reduces a contiguous sum by another scheme) every output within
# K9_RTOL of its scale. Timed at each instantiation's main shape (K2_MAIN_OF).
K9_RTOL = {torch.float64: 1e-12, torch.float32: 1e-6}
K9_ENTRIES = {"rollout": "quaternion_mpc_tpu/solver/fleet.py:728",
              "price": "quaternion_mpc_tpu/solver/fleet.py:388"}


def _k9_differ(got, want):
    """(elements whose values differ, NaN matching NaN; elements non-finite
    on one side only; the largest |difference| of the finite ones)."""
    nan = torch.isnan(got) & torch.isnan(want)
    differ = int(((got != want) & ~nan).sum())
    one_side = int((torch.isfinite(got) != torch.isfinite(want)).sum())
    finite = torch.isfinite(got) & torch.isfinite(want)
    worst = float((got - want)[finite].abs().max()) if bool(finite.any()) else 0.0
    return differ, one_side, worst


def _k9_rel(got, want, per_scenario=False):
    """The largest |difference| of the finite elements over the largest
    finite |want| (``per_scenario``: over max(|want|, 1) each)."""
    finite = torch.isfinite(got) & torch.isfinite(want)
    if not bool(finite.any()):
        return 0.0
    w = torch.where(finite, want, 0.0).double()
    scale = w.abs().clamp_min(1.0) if per_scenario else w.abs().max().clamp_min(1e-300)
    return float((torch.where(finite, got.double() - w, 0.0).abs() / scale).max())


def _k9_lam(prob, N, B, dtype, device, seed=5):
    """Multipliers drawn (half zero, the rest up to 200: some rows active,
    some not)."""
    nc = prob.Cu.shape[0]
    rng = np.random.default_rng(seed)
    lam = 200.0 * rng.random((N, nc, B)) * (rng.random((N, nc, B)) < 0.5)
    return torch.from_numpy(lam).to(device, dtype)


def phase_rollout_vs_plain(device):
    """K9 against its plain versions (see K9_RTOL's note). Returns
    ({entry: {instantiation: the f32 kernel's largest absolute error at its
    main shape}}, {"xs" / "lam_bar" / "J": elements that differ at B > 1,
    of}), holding xs and λ̄ to 0 there."""
    from quaternion_mpc_tpu_torch.kernels import line_search as k2
    from quaternion_mpc_tpu_torch.kernels import rollout as k9

    worst = {entry: {} for entry in K9_ENTRIES}
    differ = {"xs": [0, 0], "lam_bar": [0, 0], "J": [0, 0]}
    faults = []
    for dtype in (torch.float32, torch.float64):
        rtol = K9_RTOL[dtype]
        for tag, name, (spec, prob, kw) in _k2_cases(dtype, device):
            B, N = kw["xs"].shape[-1], kw["us"].shape[0]
            us = prob.us_init
            before = (k9.rollout.launches, k9.price.launches)
            xs = k9.rollout(spec, prob, us)
            want_xs = k9.open_loop_rollout_ref(spec, prob, us)
            lam = _k9_lam(prob, N, B, dtype, device)
            it = k2.line_search_ref(spec, prob, **kw)
            tiny = torch.full((), 1e-30, dtype=dtype, device=device)
            runs = [("xs", xs, want_xs, False)]
            for what, (x, u, l, r, cost, bar) in {
                    "rollout priced": (xs, us, lam, kw["rho"], True, True),
                    "multiplier update": (xs, us, lam, kw["rho"], False, True),
                    "final cost": (xs, us, None, tiny, True, False),
                    "mid-solve iterate priced": (it[0], it[1], lam, kw["rho"], True, True)}.items():
                got = k9.price(spec, prob, x, u, l, r, cost, bar)
                want = k9.price_ref(spec, prob, x, u, l, r, cost, bar)
                runs += [(f"{what} J", got[0], want[0], True)] if cost else []
                runs += [(f"{what} λ̄", got[1], want[1], False)] if bar else []
            torch.cuda.synchronize()
            _check((k9.rollout.launches, k9.price.launches) == (before[0] + 1, before[1] + 4),
                   f"K9 {tag}: the rollout or the pricing did not launch")
            line = []
            for what, got, want, per_scenario in runs:
                n, one_side, abs_err = _k9_differ(got, want)
                rel = _k9_rel(got, want, per_scenario)
                kind = "xs" if what == "xs" else "J" if what.endswith("J") else "lam_bar"
                if B > 1:
                    differ[kind][0] += n
                    differ[kind][1] += got.numel()
                    if kind != "J" and n:
                        faults.append(f"{tag} {what}: {n} of {got.numel()} elements differ "
                                      f"(largest |difference| {abs_err:.3e})")
                if one_side or rel > rtol:
                    faults.append(f"{tag} {what}: {one_side} elements non-finite on one side, "
                                  f"{rel:.3e} of scale (tol {rtol})")
                entry = "rollout" if what == "xs" else "price"
                if dtype == torch.float32 and tag == K2_MAIN_OF[K2_MODEL[name]]:
                    worst[entry][K2_MODEL[name]] = max(worst[entry].get(K2_MODEL[name], 0.0),
                                                       abs_err)
                line.append(f"{what} {n} differ ({rel:.1e})")
            print(f"[kernel] K9 {tag} vs plain: " + "; ".join(line))
    print(f"[kernel] K9: at B > 1, of the plain version's elements, xs {differ['xs'][0]} of "
          f"{differ['xs'][1]:,} differ, λ̄ {differ['lam_bar'][0]} of {differ['lam_bar'][1]:,}, J "
          f"{differ['J'][0]} of {differ['J'][1]:,}")
    _check(not faults, "K9 against its plain versions:\n" + "\n".join(faults))
    return worst, differ


# K9 alone at each instantiation's main shape (K2_MAIN_OF's, by K2_TIMED's
# tags), the fleet step's f64 and B=1 shapes, and the fleet throughput's B=256
# and B=16384
K9_TIMED = ((torch.float32, "standing", HORIZON, 8, 4096),
            (torch.float32, "convex", HORIZON, 8, 4096),
            (torch.float64, "convex_fixture", 30, 12, 256),
            (torch.float32, "falling_cat", 40, 12, 4096),
            (torch.float64, "standing", HORIZON, 8, 4096), (torch.float32, "standing", 6, 12, 1),
            (torch.float32, "standing", HORIZON, 8, 256),
            (torch.float32, "standing", HORIZON, 8, 16384))


def phase_rollout_timing(device):
    """K9's entries alone at K9_TIMED: the rollout of us_init, the
    multiplier update (λ̄ alone) and the final cost (J alone, no λ), each by
    CUDA events around a replayed graph of 50 launches beside its bound
    (`kernels.rollout.rollout_work`, `price_work` over the card's peaks),
    the host's time in one call and the plain version's time. Returns {tag:
    {"ms", "host_enqueue_ms", "plain_ms", "bound_ms", "bound_by"}}, tags
    "<K2's shape tag> <call>"."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.kernels import rollout as k9

    by_shape = {}
    for dtype, name, horizon, n_alphas, batch in K9_TIMED:
        spec, prob, kw = examples.line_search_case(name, batch, dtype, device, horizon, n_alphas)
        us, xs = prob.us_init, kw["xs"]
        lam = _k9_lam(prob, horizon, batch, dtype, device)
        tiny = torch.full((), 1e-30, dtype=dtype, device=device)
        calls = {
            "rollout": (lambda: k9.rollout(spec, prob, us),
                        lambda: k9.open_loop_rollout_ref(spec, prob, us),
                        k9.rollout_work(spec, prob, us)),
            "multiplier update": (
                lambda: k9.price(spec, prob, xs, us, lam, kw["rho"], False, True),
                lambda: k9.price_ref(spec, prob, xs, us, lam, kw["rho"], False, True),
                k9.price_work(spec, prob, xs, us, lam, kw["rho"], False, True)),
            "final cost": (lambda: k9.price(spec, prob, xs, us, None, tiny),
                           lambda: k9.price_ref(spec, prob, xs, us, None, tiny),
                           k9.price_work(spec, prob, xs, us, None, tiny)),
        }
        for call, (launch, plain, work) in calls.items():
            ms = _graph_time(launch, reps=50) * 1e3
            host_ms = _enqueue_time(launch) * 1e3
            plain_ms = _event_time(plain, reps=3) * 1e3
            bound_ms, bound_by = _bound(work, dtype)
            tag = f"{_k2_shape(name, dtype, horizon, n_alphas, batch)} {call}"
            by_shape[tag] = {"ms": ms, "host_enqueue_ms": host_ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by}
            print(f"[timing] K9 {tag}: kernel {ms:.4f} ms (graph replay; host {host_ms:.4f} ms "
                  f"a call), bound {bound_ms:.5f} ms by {bound_by} ({100 * bound_ms / ms:.2f}% "
                  f"of it reached), plain {plain_ms:.3f} ms")
    return by_shape


def _k9_kernel(name):
    """(entry, instantiation, dtype, feet) of a K9 kernel's mangled name."""
    m = re.search(r"(rollout|price)_kernelI([fd]).*?(QuatSrbMidpoint|EulerSrb|AttitudeMidpoint)"
                  r"I(?:Li(\d)E)?(?:Lb([01])E)?", name)
    inst = {"QuatSrbMidpoint": "quat_srb_midpoint", "AttitudeMidpoint": "attitude_midpoint",
            "EulerSrb": "euler_srb_euler" if m[5] == "1" else "euler_srb_midpoint"}[m[3]]
    return m[1], inst, "float32" if m[2] == "f" else "float64", int(m[4] or 1)


def _k9_registers(kbuild, lib):
    """K9's registers, stack and spill a thread by entry and instantiation,
    as ptxas reported them."""
    return {"{} {} {} n_feet={}".format(*_k9_kernel(k["name"])): [k["registers"], k["stack"],
                                                                 k["stores"]]
            for k in kbuild.ptxas_report(lib)}


# --kernels-only: other builds of K2 (the same source with a build option,
# and with --k2-baseline another source with the same C interface), held bit
# for bit against the shipped build at K2_CHECKED's shapes, the hard case and
# the runaway case, and timed in turns with it at K2_TIMED's and
# K2_DESIGN_SHAPES' shapes (a baseline only at the instantiations it has);
# the launch plans swept at both; then the clocks of each pass.
# K2_DESIGN_SHAPES lie between K2_TIMED's batch sizes, where the plans change.
K2_DESIGN_SHAPES = tuple((torch.float32, name, n, k, b)
                         for name, n, k, bs in (("standing", HORIZON, 8, (1, 16, 64, 256, 1024,
                                                                          2048)),
                                                ("standing", 6, 12, (16, 64, 256, 1024)),
                                                ("standing", HORIZON, 12, (4096,)),
                                                ("convex", HORIZON, 8, (256, 1024)),
                                                ("falling_cat", 40, 12, (64, 256, 1024, 16384)))
                         for b in bs)
K2_VARIANTS = {"trajectories in device memory": ("-DK2_TRAJ_IN_DEVICE_MEMORY",),
               "plans": ("-DK2_PLAN_OVERRIDE",)}
# the plans swept: (scenarios a block S, lanes an alpha P)
K2_PLANS = tuple((S, P) for P in (1, 2) for S in (1, 2, 4, 8, 16, 32, 64))
# -DK2_PHASE_CLOCKS: what each stamp of thread 0 of the middle block ends
# (csrc/line_search.cu): the prologue, the pricing, the wait for knot 0; per
# knot the copies of the next one, the rollout and (after the first) the wait
# at the knot's barrier; then the wait for knot N, the terminal cost, the
# select, the barrier before the write and the write.
K2_PASSES = ("start the constants' and knot 0's copies, model", "pricing", "wait for knot 0",
             "start the next knot's copies", "rollout of a knot", "wait at a knot's barrier",
             "wait for knot N", "terminal cost", "select", "barrier", "write xs, us")


def _k2_differ(got, want):
    """(elements whose bits differ, NaN matching NaN of any sign or payload;
    the largest |difference| of the finite ones) over the line search's
    outputs."""
    differ, worst = 0, 0.0
    for g, w in zip(got, want):
        if g is None:
            continue
        if g.dtype == torch.bool:
            differ += int((g != w).sum())
            continue
        bits = torch.int32 if g.dtype == torch.float32 else torch.int64
        nan = torch.isnan(g) & torch.isnan(w)
        differ += int(((g.view(bits) != w.view(bits)) & ~nan).sum())
        finite = torch.isfinite(g) & torch.isfinite(w)
        if bool(finite.any()):
            worst = max(worst, float((g - w)[finite].abs().max()))
    return differ, worst


def _k2_clock_split(stamps, N):
    """Clocks of each of K2_PASSES from one launch's 3N + 9 stamps."""
    d = np.diff(stamps[1:3 * N + 9])
    knots = d[3:3 + 3 * N - 1]  # stage 0, rollout 0, then (wait, stage, rollout) a knot
    waits = knots[2::3]
    return dict(zip(K2_PASSES, (d[0], d[1], d[2], knots[0::3].sum(), knots[1::3].sum(),
                                waits.sum(), *d[3 + 3 * N - 1:]))), int(stamps[1] - stamps[0])


def _k1_library(path):
    """A build of K1 as launch(inputs, luxs=None) -> its five outputs at the
    problem's size: a build of this source at the instantiation the wrapper
    picks, or of the parent's (its 12 x 12 kernel and the cross term's
    entries; what it launched for a smaller problem: `embed` into 12 x 12,
    the live block)."""
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    lib = ctypes.CDLL(str(path))
    templated = hasattr(lib, "riccati_sweep_shapes")
    names = ("riccati_sweep_f32", "riccati_sweep_f64") + (
        () if templated else ("riccati_sweep_lux_f32", "riccati_sweep_lux_f64"))
    for name in names:
        pointers = 15 if templated or "lux" in name else 14
        getattr(lib, name).argtypes = ([ctypes.c_int] * 2 * templated + [ctypes.c_void_p] * pointers
                                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        getattr(lib, name).restype = ctypes.c_int

    def launch(args, luxs=None):
        horizon, ne, batch, nu = args[0].shape[0], args[0].shape[1], args[0].shape[-1], args[1].shape[2]
        size = rs.instantiation(ne, nu, luxs is not None) if templated else (12, 12)
        inputs, lux = args, luxs
        if size != (ne, nu):
            big = rs.embed(*args, luxs=luxs, size=size)
            inputs, lux = big[:9], None if luxs is None else big[9]
        like = dict(dtype=args[0].dtype, device=args[0].device)
        outs = (torch.empty((horizon, size[1], size[0], batch), **like),
                torch.empty((horizon, size[1], batch), **like), *(torch.empty_like(args[8])
                                                                  for _ in range(3)))
        t = "f32" if args[0].dtype == torch.float32 else "f64"
        lux_pointers = [None if lux is None else lux.data_ptr()] if templated or lux is not None else []
        pointers = ([x.data_ptr() for x in inputs[:6]] + lux_pointers
                    + [x.data_ptr() for x in (*inputs[6:], *outs)])
        fn = getattr(lib, f"riccati_sweep_{'lux_' if lux is not None and not templated else ''}{t}")
        err = fn(*(size if templated else ()), *pointers, horizon, batch,
                 torch.cuda.current_stream().cuda_stream)
        _check(err == 0, f"{path.name}: launch at {size} failed with CUDA error {err}")
        return (outs[0][:, :nu, :ne], outs[1][:, :nu], *outs[2:])

    return launch


def phase_k1_baseline(device, baseline):
    """--kernels-only --k1-baseline SOURCE, SOURCE the parent's
    csrc/riccati_sweep.cu beside its own warp_tile.cuh and assoc_scan.cu:
    K4 built from the parent's source and header, its ptxas lines and its
    PTX against the shipped build's (they must be the same); K1 built from
    the parent's source and from copies of this one with one shape line
    changed (the 12 x 12 instantiations by the group body; falling_cat's 6 x 3
    at 16 and at 4 lanes a scenario), each held element by element against
    the shipped build on phase 3's inputs (12 x 12; the parent's must equal
    it in every element) and on phase 12's falling_cat and humanoid inputs,
    and timed in turns with it by events around a replayed graph of 20
    launches (the parent's through `embed` below 12 x 12, as it ran)."""
    from quaternion_mpc_tpu_torch.kernels import assoc_scan as k4
    from quaternion_mpc_tpu_torch.kernels import build as kbuild
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    parent = pathlib.Path(baseline).resolve()
    text = rs.SOURCE.read_text()
    edits = {"group body at 12x12": ("WARP12 = NE == 12 && NU == 12", "WARP12 = false"),
             "6x3 at 16 lanes": ("NE > 4 ? 8 : 4", "NE > 4 ? 16 : 4"),
             "6x3 at 4 lanes": ("NE > 4 ? 8 : 4", "NE > 4 ? 4 : 4")}
    sources = {"parent": parent}
    kbuild.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name, (old, new) in edits.items():
        _check(text.count(old) == 1, f"K1 variant {name}: {old!r} not found once")
        path = kbuild.BUILD_DIR / f"riccati_sweep_{re.sub(r'[^a-z0-9]+', '_', name)}.cu"
        path.write_text(text.replace(old, new))
        sources[name] = path
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        k4_parent = pool.submit(kbuild.build, parent.parent / "assoc_scan.cu")
        paths = dict(zip(sources, pool.map(kbuild.build, sources.values())))
        k4_parent = k4_parent.result()
    print(f"[K1] {len(paths) + 1} more builds in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        for k in kbuild.ptxas_report(path):
            where = (_k1_tag(*_k1_kernel(k["name"])[:3]) + " " + _k1_kernel(k["name"])[3]
                     if "Shape" in k["name"] else k["name"][-30:])
            print(f"[K1] ptxas {name} {where}: {k['registers']} registers, {k['stack']} bytes "
                  f"stack, spill {k['stores']} / {k['loads']} bytes")
    shipped_k4 = [(k["name"], k["registers"], k["stack"], k["stores"], k["loads"])
                  for k in kbuild.ptxas_report(k4.build())]
    parent_k4 = [(k["name"], k["registers"], k["stack"], k["stores"], k["loads"])
                 for k in kbuild.ptxas_report(k4_parent)]
    # the machine code of the two builds (cuobjdump's SASS), and where their
    # PTX differs
    sass, ptx = [], []
    cuobjdump = pathlib.Path(kbuild._nvcc()).with_name("cuobjdump")
    for i, (src, lib) in enumerate(((k4.SOURCE, k4.build()),
                                    (parent.parent / "assoc_scan.cu", k4_parent))):
        out = kbuild.BUILD_DIR / f"assoc_scan_{i}.ptx"
        subprocess.run([kbuild._nvcc(), "-arch=sm_90a", "-std=c++17", "-O3", "--ptx", "-I",
                        str(src.parent), "-o", str(out), str(src)], check=True)
        ptx.append([line for line in out.read_text().splitlines() if not line.startswith("//")])
        dump = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
        sass.append([line.split("/*", 2)[-1] if "/*" in line else line
                     for line in dump.splitlines() if "Function" in line or "/*" in line])
    off = [(a, b) for a, b in zip(*ptx) if a != b]
    print(f"[K1] K4 from the parent's source and header: ptxas lines "
          f"{'the same' if shipped_k4 == parent_k4 else 'DIFFERENT'}; SASS "
          f"{'the same' if sass[0] == sass[1] else 'DIFFERENT'} ({len(sass[0])} / {len(sass[1])} "
          f"lines); PTX {len(ptx[0])} / {len(ptx[1])} lines, {len(off)} of them differ"
          + "".join(f"\n[K1]   PTX {a.strip()!r} | parent {b.strip()!r}" for a, b in off[:6]))
    _check(shipped_k4 == parent_k4 and sass[0] == sass[1],
           f"K4's code moved with the header: {shipped_k4} against {parent_k4}")

    launches = {name: _k1_library(path) for name, path in paths.items()}
    shipped = lambda args, luxs=None: rs.riccati_sweep(*args, luxs=luxs)
    cases = [(f"{str(dtype)[6:]} N={horizon} B={batch}", _sweep_inputs(batch, dtype, device,
                                                                        horizon), None)
             for dtype in (torch.float32, torch.float64) for horizon, batches in K1_CHECKED.items()
             for batch in batches]
    cases += [(f"{str(dtype)[6:]} go1 lux B={batch}", *_go1_cross(batch, dtype, device))
              for dtype in (torch.float32, torch.float64) for batch in (7, 4096)]
    cases += [(f"{str(dtype)[6:]} {family} N={horizon} B={batch}",
               _family_first_pass(family, horizon, batch, dtype, device), None)
              for dtype in (torch.float32, torch.float64)
              for family in ("falling_cat", "humanoid") for horizon in SINGLE_CHECKED_N
              for batch in SINGLE_CHECKED_B]
    differ = {name: [0, 0, 0] for name in launches}  # elements, of, launches with any
    refused = {name: 0 for name in launches}
    for tag, args, luxs in cases:
        want = shipped(args, luxs)
        for name, launch in launches.items():
            if name == "6x3 at 4 lanes" and args[0].dtype == torch.float64:
                refused[name] += 1  # 64 scenarios a block: past an SM's shared memory in f64
                continue
            n_diff, n_all = _differ(launch(args, luxs), want)
            differ[name][0] += n_diff
            differ[name][1] += n_all
            differ[name][2] += n_diff > 0
            if name == "parent" and tag.split(" ")[1].startswith(("N=", "go1")):
                _check(n_diff == 0, f"K1 12x12 {tag}: {n_diff} elements differ from the parent's build")
        torch.cuda.synchronize()
    for name, (n_diff, n_all, off) in differ.items():
        print(f"[K1] {name}: {n_diff} of {n_all} elements differ from the shipped build, in {off} "
              f"of {len(cases) - refused[name]} launches (phase 3's 12x12 shapes, the drawn mixed "
              f"rows, phase 12's falling_cat and humanoid shapes; f32 only at 4 lanes)")

    timed = (("f32 N=10 B=4096", _sweep_inputs(4096, torch.float32, device), ("parent", "group body at 12x12")),
             ("f32 N=10 B=16384", _sweep_inputs(16384, torch.float32, device),
              ("parent", "group body at 12x12")),
             ("f32 falling_cat N=40 B=4096", _k1_timed_shapes()[0][2](torch.float32, device)[0],
              ("parent", "6x3 at 16 lanes", "6x3 at 4 lanes")),
             ("f32 humanoid N=20 B=256", _family_first_pass("humanoid", 20, 256, torch.float32,
                                                           device), ("parent",)))
    for tag, args, others in timed:
        fns = {"shipped": lambda: shipped(args), **{n: (lambda n=n: launches[n](args)) for n in others}}
        times = {n: [] for n in fns}
        for _ in range(2):
            for n, fn in fns.items():
                times[n].append(_graph_time(fn, reps=20) * 1e3)
        print(f"[K1] timed in turns, {tag}: " + "; ".join(
            f"{n} {' / '.join(f'{t:.4f}' for t in ts)} ms" for n, ts in times.items()))


def phase_k2_designs(device, baseline=None):
    """--kernels-only: K2 built with each of K2_VARIANTS and, given
    ``baseline``, that source (as it was built: K2's FLAGS), each held bit
    for bit against the shipped build (every output, f32 and f64, J given and
    priced, at K2_CHECKED's shapes and the hard case; NaN matches NaN of any
    sign) and timed in turns with it (shipped, the others, then back) by
    events around a replayed graph at K2_TIMED's and K2_DESIGN_SHAPES'
    shapes. The variants must agree exactly (they move work, not
    arithmetic); the baseline's count of differing elements is printed and
    held to 0 too. Then every launch plan of K2_PLANS (scenarios a block,
    lanes an alpha) that a shape can take, timed in turns through the
    -DK2_PLAN_OVERRIDE build, beside the one the kernel chooses; the
    wrapper's host time by part; and the -DK2_PHASE_CLOCKS build: the clocks
    of each pass (K2_PASSES), thread 0 of the middle block, J given and
    priced."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.kernels import build as kbuild
    from quaternion_mpc_tpu_torch.kernels import line_search as k2

    builds = {name: lambda flags=flags: kbuild.build(k2.SOURCE, k2.FLAGS + flags)
              for name, flags in K2_VARIANTS.items()}
    builds["clocks"] = lambda: kbuild.build(k2.SOURCE, k2.FLAGS + ("-DK2_PHASE_CLOCKS",))
    if baseline:
        builds["baseline"] = lambda: kbuild.build(pathlib.Path(baseline).resolve(), k2.FLAGS)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        paths = dict(zip(builds, pool.map(lambda build: build(), builds.values())))
    print(f"[K2] {len(paths)} more builds in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        for k in kbuild.ptxas_report(path):
            print(f"[K2] ptxas {name} {k['name'][-24:]}: {k['registers']} registers, "
                  f"{k['stack']} bytes stack, spill {k['stores']} / {k['loads']} bytes")
    libs = {"shipped": k2._lib(), **{name: k2.bind(path) for name, path in paths.items()}}
    others = [name for name in libs if name != "shipped"]

    cases = [case for dtype in (torch.float32, torch.float64) for case in _k2_cases(dtype, device)]
    differ = {name: [0, 0.0, 0, 0] for name in others}  # elements, largest, launches off, launches
    for tag, name, (spec, prob, kw) in cases:
        for given in (True, False):
            kw_run = kw if given else {**kw, "J": None}
            want = k2.launch(libs["shipped"], spec, prob, **kw_run, with_costs=True)
            for lib_name in others:
                if K2_MODEL[name] not in libs[lib_name].instantiations:
                    continue
                n, worst = _k2_differ(k2.launch(libs[lib_name], spec, prob, **kw_run,
                                                with_costs=True), want)
                d = differ[lib_name]
                d[0], d[1], d[2], d[3] = d[0] + n, max(d[1], worst), d[2] + (n > 0), d[3] + 1
    torch.cuda.synchronize()
    for lib_name, (n, worst, cases_off, launches) in differ.items():
        print(f"[K2] bits: {lib_name} ({', '.join(libs[lib_name].instantiations)}) against the "
              f"shipped build over {launches} launches (every output; K2_CHECKED's shapes, the "
              f"hard case and the runaway case of its instantiations, f32 and f64, J given and "
              f"priced): {n} elements differ in {cases_off} launches, largest |difference| "
              f"{worst:.3e}")
    _check(all(d[0] == 0 for d in differ.values()),
           f"K2: a build's outputs differ from the shipped build's: {differ}")

    timed = ["shipped", *(name for name in others if name != "clocks")]
    for dtype, name, horizon, n_alphas, batch in K2_TIMED + K2_DESIGN_SHAPES:
        spec, prob, kw = examples.line_search_case(name, batch, dtype, device, horizon, n_alphas)
        here = [lib_name for lib_name in timed if K2_MODEL[name] in libs[lib_name].instantiations]
        times = {lib_name: [] for lib_name in here}
        for lib_name in here + here[::-1]:
            lib = libs[lib_name]
            times[lib_name].append(_graph_time(
                lambda: k2.launch(lib, spec, prob, **kw, with_costs=False), reps=50) * 1e3)
        bound_ms, _ = _bound(k2.work(spec, prob, **kw), dtype)
        print(f"[K2] designs {_k2_shape(name, dtype, horizon, n_alphas, batch)}, in turns forward / "
              f"backward (bound {bound_ms:.5f} ms): " + "; ".join(
                  f"{lib_name} {times[lib_name][0]:.4f} / {times[lib_name][1]:.4f} ms "
                  f"({100 * bound_ms / statistics.mean(times[lib_name]):.2f}% of the bound)"
                  for lib_name in here))

    # the plans: every (S, P) that a launch of the shape can take, in turns
    lib = libs["plans"]
    lib.line_search_override.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.line_search_override.restype = None
    for dtype, name, horizon, n_alphas, batch in K2_TIMED + K2_DESIGN_SHAPES:
        spec, prob, kw = examples.line_search_case(name, batch, dtype, device, horizon, n_alphas)
        lanes = k2.group_lanes(n_alphas)
        most = 256
        plans = [(S, P) for S, P in K2_PLANS if (P == 1 or lanes <= 16)
                 and 32 <= S * lanes * P <= most and (S < 2 * batch or S * lanes * P == 32)]
        times = {plan: [] for plan in plans}
        for plan in plans + plans[::-1]:
            lib.line_search_override(*plan)
            times[plan].append(_graph_time(
                lambda: k2.launch(lib, spec, prob, **kw, with_costs=False), reps=20) * 1e3)
        lib.line_search_override(0, 0)
        best = min(plans, key=lambda plan: statistics.mean(times[plan]))
        print(f"[K2] plans {_k2_shape(name, dtype, horizon, n_alphas, batch)} (S scenarios a "
              f"block, P lanes an alpha; ms, in turns forward / backward): " + "; ".join(
                  f"S={S} P={P} {times[(S, P)][0]:.4f} / {times[(S, P)][1]:.4f}"
                  for S, P in plans) + f"; fastest S={best[0]} P={best[1]}")

    # the wrapper's host time a call, by part, at the fleet's shape
    dtype, name, horizon, n_alphas, batch = K2_TIMED[0]
    spec, prob, kw = examples.line_search_case(name, batch, dtype, device, horizon, n_alphas)
    table, extras, dims = k2.check_inputs(spec, prob, **kw)
    outputs, scratch = k2.new_outputs(dims, kw["xs"], False)
    parts = {
        "check_inputs": lambda: k2.check_inputs(spec, prob, **kw),
        "new_outputs": lambda: k2.new_outputs(dims, kw["xs"], False),
        "c_tables": lambda: k2.c_tables(table, (*extras, scratch), outputs),
        "line_search": lambda: k2.line_search(spec, prob, **kw),
    }
    print(f"[K2] the wrapper's host time a call at {K2_MAIN}: " + ", ".join(
        f"{part} {_enqueue_time(fn) * 1e3:.4f} ms" for part, fn in parts.items()))

    lib = libs["clocks"]
    lib.line_search_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.line_search_clocks.restype = ctypes.c_int
    for dtype, name, horizon, n_alphas, batch in K2_TIMED:
        spec, prob, kw = examples.line_search_case(name, batch, dtype, device, horizon, n_alphas)
        for given in (True, False):
            k2.launch(lib, spec, prob, **(kw if given else {**kw, "J": None}), with_costs=False)
            stamps = np.zeros(3 * horizon + 9, dtype=np.int64)
            _check(lib.line_search_clocks(stamps.ctypes.data, len(stamps)) == 0,
                   "reading K2's clocks failed")
            split, stamp = _k2_clock_split(stamps, horizon)
            print(f"[K2] clocks {_k2_shape(name, dtype, horizon, n_alphas, batch)} "
                  f"{'J given' if given else 'J priced'} (thread 0 of the middle block; two stamps "
                  f"back to back {stamp}): {int(sum(split.values()))} in all: "
                  + ", ".join(f"{p} {int(c)}" for p, c in split.items()))


# --kernels-only: other builds of K9 (the same source with a build option,
# and with --k9-baseline another source with the same C interface: the
# parent's csrc/rollout.cu beside its own headers), each held bit for bit
# against the shipped build, and timed in turns with it at K9_TIMED's shapes;
# the launch plans swept; and what cuobjdump's SASS of each build holds.
K9_VARIANTS = {"unstaged": ("-DK9_UNSTAGED",), "plans": ("-DK9_PLAN_OVERRIDE",)}
# the plans swept: the rollout's (S scenarios a block, threads); the
# pricing's (S, knot rows), and the multiplier update's knots a block from
# the rows up
K9_ROLL_PLANS = ((8, 32), (8, 64), (8, 96), (16, 32), (16, 64), (16, 160), (16, 256),
                 (32, 32), (32, 64), (32, 128), (32, 256), (64, 64), (64, 128), (64, 256))
K9_PRICE_PLANS = ((8, 1), (8, 2), (8, 4), (8, 8), (16, 1), (16, 2), (16, 4), (32, 1), (32, 2))
# -DK9_PHASE_CLOCKS: the stamps of thread 0 of one block; the rollout: 0
# start, 1 the constants' barrier, 2 the first pass's drives, 3 + k after
# the chain's step k; the pricing: 0 start, 1 the copies issued, 2 the
# weights and the first knot's operands loaded and the copies landed (a
# barrier), 3 the knots, 4 the AL terms' divisions between two barriers, 5
# J written.
K9_PRICE_PHASES = ("issue the copies of Cu, cb and λ",
                   "the weights, the first knot's loads, the wait for the copies",
                   "the knots (state and input sums, the inequality's rows)",
                   "the AL terms' divisions (two barriers)", "sum over the knots")


def _k9_launcher(lib, spec, prob, us, xs=None, lam=None, rho=None, cost=True, lam_bar=False):
    """fn() that launches ``lib``'s K9 once into outputs made once and returns
    them: the rollout of ``us`` where ``xs`` is None, else the pricing of
    (xs, us) (J with ``cost``, λ̄ with ``lam_bar``); the tables are made once
    too, so that fn() is the kernel's launch alone."""
    from quaternion_mpc_tpu_torch.kernels import rollout as k9

    like = dict(dtype=us.dtype, device=us.device)
    N, B = us.shape[0], us.shape[-1]
    if xs is None:
        table, dims = k9.check_rollout(spec, prob, us)
        outputs = (torch.empty((N + 1, spec.nx, B), **like), None, None)
    else:
        table, dims = k9.check_price(spec, prob, xs, us, lam, rho)
        nc = dims[3]
        outputs = (None, torch.empty((B,), **like) if cost else None,
                   torch.empty((N, nc, B), **like) if lam_bar else None)
    tables = k9.c_tables(table, outputs)
    entry = getattr(lib, k9._ENTRY[(xs is not None, us.dtype)])

    def fn():
        err = entry(*tables, *dims, torch.cuda.current_stream().cuda_stream)
        _check(err == 0, f"K9 launch failed with CUDA error {err}")
        return outputs

    fn.table, fn.dims, fn.outputs = table, dims, outputs  # the copies live as long as fn
    return fn


def _k9_calls(lib, spec, prob, kw, lam, plain_calls=False):
    """{call: fn} of K9 on a problem: the rollout of us_init and, on that
    rollout (the plain version's, so that every build prices the same xs),
    the pricings the solver and phase 3 make: J and λ̄ with λ given and
    with λ absent, the multiplier update (λ̄ alone), the final cost (J alone,
    no λ, ρ = 1e-30), λ̄ alone with λ absent."""
    from quaternion_mpc_tpu_torch.kernels import rollout as k9

    us, rho = prob.us_init, kw["rho"]
    xs = k9.open_loop_rollout_ref(spec, prob, us)
    tiny = torch.full((), 1e-30, dtype=us.dtype, device=us.device)
    return {"rollout": _k9_launcher(lib, spec, prob, us),
            "J and λ̄, λ given": _k9_launcher(lib, spec, prob, us, xs, lam, rho, True, True),
            "J and λ̄, λ absent": _k9_launcher(lib, spec, prob, us, xs, None, rho, True, True),
            "multiplier update": _k9_launcher(lib, spec, prob, us, xs, lam, rho, False, True),
            "final cost": _k9_launcher(lib, spec, prob, us, xs, None, tiny, True, False),
            "λ̄ alone, λ absent": _k9_launcher(lib, spec, prob, us, xs, None, rho, False, True)}


def _k9_sass(kbuild, lib, out_path):
    """cuobjdump's SASS of a K9 build to out_path; {kernel: {"instructions",
    opcode: count}} of its kernels (by `_k9_kernel`'s names)."""
    cuobjdump = pathlib.Path(kbuild._nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(dump)
    kernels, name = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = "{} {} {} n_feet={}".format(*_k9_kernel(m[1])) if "_kernel" in m[1] else None
            if name:
                kernels[name] = {"instructions": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if name and m:
            op = m[1]
            kernels[name]["instructions"] += 1
            kernels[name][op] = kernels[name].get(op, 0) + 1
    return kernels


def phase_k9_designs(device, baseline=None):
    """--kernels-only: K9 built with each of K9_VARIANTS and, given
    ``baseline``, that source (as it was built: K9's FLAGS), each held bit
    for bit against the shipped build (xs, λ̄ and J, every element, NaN
    matching NaN of any sign) on `_k9_calls`' launches at K2_CHECKED's shapes
    (B=1 included), the hard case and the falling_cat runaway case, f32 and
    f64, and timed in turns with it (the shipped build, the others, then back:
    shipped, parent, parent, shipped with the baseline alone) by events
    around a replayed graph at K9_TIMED's shapes: the rollout, the
    multiplier update and the final cost; first the SASS of the shipped
    and the baseline builds (cuobjdump), each kernel's instructions counted
    by opcode (the quaternion SRB's four feet printed; each whole dump
    beside its library, `.sass`). Then every plan of K9_ROLL_PLANS and
    K9_PRICE_PLANS a shape can take, timed in turns through the
    -DK9_PLAN_OVERRIDE build beside the one the policy picks."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.kernels import build as kbuild
    from quaternion_mpc_tpu_torch.kernels import rollout as k9

    builds = {name: lambda flags=flags: kbuild.build(k9.SOURCE, k9.FLAGS + flags)
              for name, flags in K9_VARIANTS.items()}
    if baseline:
        builds["parent"] = lambda: kbuild.build(pathlib.Path(baseline).resolve(), k9.FLAGS)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        paths = dict(zip(builds, pool.map(lambda build: build(), builds.values())))
    print(f"[K9] {len(paths)} more builds in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        for k in kbuild.ptxas_report(path):
            if "n_feet=4" in (tag := "{} {} {} n_feet={}".format(*_k9_kernel(k["name"]))) \
                    or "attitude" in tag:
                print(f"[K9] ptxas {name} {tag}: {k['registers']} registers, {k['stack']} bytes "
                      f"stack, spill {k['stores']} / {k['loads']} bytes")
    libs = {"shipped": k9._lib(), **{name: k9.bind(path) for name, path in paths.items()}}
    others = [name for name in libs if name != "shipped"]

    # the machine code: instructions by opcode, the quaternion SRB at four feet
    for lib_name in ("shipped", *(["parent"] if baseline else [])):
        path = k9.build() if lib_name == "shipped" else paths[lib_name]
        kernels = _k9_sass(kbuild, path, path.with_suffix(".sass"))
        print(f"[K9] SASS {lib_name}: {path.with_suffix('.sass')}")
        for kernel, ops in sorted(kernels.items()):
            if "quat_srb_midpoint" not in kernel or "n_feet=4" not in kernel:
                continue
            top = sorted(((n, op) for op, n in ops.items() if op != "instructions"), reverse=True)
            print(f"[K9] SASS {lib_name} {kernel}: {ops['instructions']} instructions; "
                  + ", ".join(f"{op} {n}" for n, op in top[:24]))

    # bits: every element of every output against the shipped build's
    differ = {name: [0, 0, 0, 0] for name in others}  # elements, of, launches off, launches
    for dtype in (torch.float32, torch.float64):
        for tag, name, (spec, prob, kw) in _k2_cases(dtype, device):
            lam = _k9_lam(prob, prob.us_init.shape[0], prob.us_init.shape[-1], dtype, device)
            want = {call: [None if o is None else o.clone() for o in fn()]
                    for call, fn in _k9_calls(libs["shipped"], spec, prob, kw, lam).items()}
            for lib_name in others:
                for call, fn in _k9_calls(libs[lib_name], spec, prob, kw, lam).items():
                    n, _ = _k2_differ(fn(), want[call])
                    d = differ[lib_name]
                    d[0] += n
                    d[1] += sum(o.numel() for o in want[call] if o is not None)
                    d[2] += n > 0
                    d[3] += 1
                    if n:
                        print(f"[K9] bits: {lib_name} {tag} {call}: {n} elements differ")
    torch.cuda.synchronize()
    for lib_name, (n, of, off, launches) in differ.items():
        print(f"[K9] bits: {lib_name} against the shipped build over {launches} launches (xs, λ̄ "
              f"and J; K2_CHECKED's shapes, B=1 included, the hard case and the falling_cat "
              f"runaway case, f32 and f64, λ given and absent): {n} of {of:,} elements differ, "
              f"in {off} launches")
    _check(all(d[0] == 0 for d in differ.values()),
           f"K9: a build's outputs differ from the shipped build's: {differ}")

    # the builds in turns at K9_TIMED's shapes
    timed = ["shipped", *(name for name in others if name != "plans")]
    for dtype, name, horizon, n_alphas, batch in K9_TIMED:
        spec, prob, kw = examples.line_search_case(name, batch, dtype, device, horizon, n_alphas)
        lam = _k9_lam(prob, horizon, batch, dtype, device)
        fns = {lib_name: _k9_calls(libs[lib_name], spec, prob, kw, lam) for lib_name in timed}
        us = prob.us_init
        xs = k9.open_loop_rollout_ref(spec, prob, us)
        tiny = torch.full((), 1e-30, dtype=dtype, device=device)
        works = {"rollout": k9.rollout_work(spec, prob, us),
                 "multiplier update": k9.price_work(spec, prob, xs, us, lam, kw["rho"], False, True),
                 "final cost": k9.price_work(spec, prob, xs, us, None, tiny)}
        for call, work in works.items():
            times = {lib_name: [] for lib_name in timed}
            for lib_name in timed + timed[::-1]:
                times[lib_name].append(_graph_time(fns[lib_name][call], reps=50) * 1e3)
            bound_ms, bound_by = _bound(work, dtype)
            print(f"[K9] designs {_k2_shape(name, dtype, horizon, n_alphas, batch)} {call}, in "
                  f"turns forward / backward (bound {bound_ms:.5f} ms by {bound_by}): " + "; ".join(
                      f"{lib_name} {times[lib_name][0]:.4f} / {times[lib_name][1]:.4f} ms "
                      f"({100 * bound_ms / statistics.mean(times[lib_name]):.2f}% of the bound)"
                      for lib_name in timed))

    # the plans: every one a shape can take, in turns, beside the policy's
    lib = libs["plans"]
    lib.rollout_override.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.price_override.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.rollout_override.restype = lib.price_override.restype = None
    for dtype, name, horizon, n_alphas, batch in K9_TIMED:
        spec, prob, kw = examples.line_search_case(name, batch, dtype, device, horizon, n_alphas)
        lam = _k9_lam(prob, horizon, batch, dtype, device)
        calls = _k9_calls(lib, spec, prob, kw, lam)
        shape = _k2_shape(name, dtype, horizon, n_alphas, batch)
        policy = {call: k9.plans(lib, calls[call].table, calls[call].dims, calls[call].outputs,
                                 dtype, torch.cuda.get_device_properties(device).multi_processor_count)
                  for call in ("rollout", "multiplier update", "final cost")}
        price_plans = [(S, r) for S, r in K9_PRICE_PLANS if S <= 4 * batch + 32 and r <= horizon + 1]
        sweeps = {
            "rollout": [(lambda S=S, T=T: lib.rollout_override(S, T), f"S={S} T={T}")
                        for S, T in K9_ROLL_PLANS if T % S == 0 and S <= 4 * batch + 64],
            "final cost": [(lambda S=S, r=r: lib.price_override(S, r, 0), f"S={S} rows={r}")
                           for S, r in price_plans],
            "multiplier update": [(lambda S=S, r=r, k=k: lib.price_override(S, r, k),
                                   f"S={S} rows={r} knots={k}")
                                  for S, r in price_plans if r <= horizon
                                  for k in sorted({r, 2 * r, 4 * r, -(-horizon // 2), horizon})
                                  if k <= horizon],
        }
        for call, plans in sweeps.items():
            times = {label: [] for _, label in plans}
            for set_plan, label in plans + plans[::-1]:
                set_plan()
                times[label].append(_graph_time(calls[call], reps=20) * 1e3)
            lib.rollout_override(0, 0)
            lib.price_override(0, 0, 0)
            policy_ms = _graph_time(calls[call], reps=20) * 1e3
            best = min(times, key=lambda label: statistics.mean(times[label]))
            p = policy[call]
            picked = (f"S={p['roll_S']} T={p['roll_threads']} chunk={p['roll_chunk']}"
                      if call == "rollout" else
                      f"S={p['price_S']} rows={p['price_rows']} knots={p['price_knots']} groups="
                      f"{p['price_groups']} {p['price_bytes']} bytes")
            print(f"[K9] plans {shape} {call} (ms, in turns forward / backward): " + "; ".join(
                f"{label} {ts[0]:.4f} / {ts[1]:.4f}" for label, ts in times.items())
                + f"; fastest {best}; the policy's ({picked}) {policy_ms:.4f}")



# --kernels-only --k8-baseline: other sources of K8 with the same C
# interface (the quaternion SRB's body before it became a template over the
# model: a source without expansions_tags binds as that instantiation alone;
# or the shipped source with another block shape), each held bit for bit
# against the shipped build at the checked shapes of the instantiations it
# has, f32 and f64, and timed in turns with it at K8_TIMED's shapes of those,
# alone and followed by K1 on its outputs.


def _k8_launcher(lib, args):
    """fn() that launches ``lib``'s K8 once on ``args`` (`_k8_inputs`) into
    outputs made once and returns them; the tables are made once too, so
    that fn() is the kernel's launch alone."""
    from quaternion_mpc_tpu_torch.kernels import expansions as k8

    table, dims = k8.check_inputs(*args)
    outputs = k8.new_outputs(dims, args[2])
    ins, strides, outs = k8.c_tables(table, outputs)
    entry = getattr(lib, k8._ENTRY[args[2].dtype])

    def fn():
        err = entry(ins, strides, outs, *dims, torch.cuda.current_stream().cuda_stream)
        _check(err == 0, f"K8 launch failed with CUDA error {err}")
        return outputs

    fn.table = table  # the copies live as long as fn
    return fn


def phase_k8_designs(device, baselines):
    """--kernels-only --k8-baseline SOURCE[,SOURCE...]: each source built
    (K8's FLAGS, all at once), held bit for bit against the shipped build
    (every element of the eight outputs, f32 and f64, at every K8_CHECKED
    shape, B=1 included, and at K8_MODELS_CHECKED's first-iteration shapes of
    the instantiations it has) and timed in turns with it (the sources, the
    shipped build, then back) by events around a replayed graph of 50
    launches of the kernel alone at K8_TIMED's shapes of the instantiations
    it has, then of 20 launches each followed by K1 on its outputs at the
    quaternion SRB's first and last. The count of differing elements is
    printed and must be 0."""
    from quaternion_mpc_tpu_torch.kernels import build as kbuild
    from quaternion_mpc_tpu_torch.kernels import expansions as k8

    t0 = time.perf_counter()
    sources = [pathlib.Path(b).resolve() for b in baselines.split(",")]
    with concurrent.futures.ThreadPoolExecutor() as pool:
        paths = list(pool.map(lambda src: kbuild.build(src, k8.FLAGS), sources))
    print(f"[K8] {len(paths)} baseline(s) built in {time.perf_counter() - t0:.1f} s")
    libs = {"shipped": k8._lib()}
    for src, path in zip(sources, paths):
        name = f"baseline {src.name}"
        for k in kbuild.ptxas_report(path):
            print(f"[K8] ptxas {name} {k['name'][-44:]}: {k['registers']} registers, "
                  f"{k['stack']} bytes stack, spill {k['stores']} / {k['loads']} bytes")
        libs[name] = k8.bind(path)
        print(f"[K8] {name} has the instantiations {libs[name].instantiations}")

    quat_cases = [(dtype, name, horizon, batch, leaves)
                  for dtype in (torch.float32, torch.float64)
                  for name, horizon, batches, leaves in K8_CHECKED for batch in batches]
    model_cases = [c for c in K8_MODELS_CHECKED if c[4] == "first"]
    for lib_name, lib in list(libs.items())[1:]:
        n, worst, off, launches = 0, 0.0, 0, 0  # elements, largest, launches off, launches
        for dtype, name, horizon, batch, leaves in quat_cases + model_cases:
            if K8_MODEL[name] not in lib.instantiations:
                continue
            args = _k8_inputs(name, horizon, batch, dtype, device,
                              "per scenario" if leaves == "first" else leaves)
            want = _k8_launcher(libs["shipped"], args)()
            got = _k8_launcher(lib, args)()
            n_one, worst_one = _k2_differ(got, want)
            n, worst = n + n_one, max(worst, worst_one)
            off, launches = off + (n_one > 0), launches + 1
        torch.cuda.synchronize()
        print(f"[K8] bits: {lib_name} against the shipped build over {launches} launches (every "
              f"output; K8_CHECKED's shapes, B=1 included, and K8_MODELS_CHECKED's of its "
              f"instantiations, f32 and f64): {n} elements differ in {off} launches, largest "
              f"|difference| {worst:.3e}")
        _check(n == 0, f"K8: {lib_name}'s outputs differ from the shipped build's in {n} "
                       f"elements")

    for dtype, name, horizon, batch in K8_TIMED:
        order = [lib_name for lib_name, lib in libs.items()
                 if K8_MODEL[name] in lib.instantiations][1:] + ["shipped"]
        args = _k8_inputs(name, horizon, batch, dtype, device)
        times = {lib_name: [] for lib_name in order}
        for lib_name in order + order[::-1]:
            fn = _k8_launcher(libs[lib_name], args)
            times[lib_name].append(_graph_time(fn, reps=50) * 1e3)
        bound_ms, _ = _bound(k8.work(*args), dtype)
        print(f"[K8] designs {_k8_shape(dtype, horizon, batch, name)}, the kernel alone, in "
              f"turns forward / backward (bound {bound_ms:.5f} ms): " + "; ".join(
                  f"{lib_name} {times[lib_name][0]:.4f} / {times[lib_name][1]:.4f} ms "
                  f"({100 * bound_ms / statistics.mean(times[lib_name]):.2f}% of the bound)"
                  for lib_name in order))

    # each source followed by K1 on its outputs, as a backward pass runs them:
    # what K1 then reads of them from L2 depends on how K8 stored them
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    quat = [shape for shape in K8_TIMED if K8_MODEL[shape[1]] == "quat_srb_midpoint"]
    order = list(libs)[1:] + ["shipped"]
    for dtype, name, horizon, batch in quat[:1] + quat[-1:]:
        args = _k8_inputs(name, horizon, batch, dtype, device)
        reg = torch.zeros(batch, dtype=dtype, device=device)
        times = {lib_name: [] for lib_name in order}
        for lib_name in order + order[::-1]:
            fn = _k8_launcher(libs[lib_name], args)
            times[lib_name].append(_graph_time(lambda: rs.riccati_sweep(*fn(), reg), reps=20)
                                   * 1e3)
        print(f"[K8] designs {_k8_shape(dtype, horizon, batch)}, K8 then K1 on its outputs, in "
              f"turns forward / backward: " + "; ".join(
                  f"{lib_name} {times[lib_name][0]:.4f} / {times[lib_name][1]:.4f} ms"
                  for lib_name in order))


def phase_main_path(device):
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.control import quat_mpc
    from quaternion_mpc_tpu_torch.kernels import line_search as k2
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    opts = SolverOptions(al_iterations=2, ilqr_iterations=5, max_linesearch=8)
    ctrl = quat_mpc.make_fleet_controller(HORIZON, opts)
    per_solve = opts.al_iterations * opts.ilqr_iterations
    inputs = {b: examples.standing_batch(b, HORIZON, torch.float32, device) for b in FLEET_SIZES}

    rs.riccati_sweep.launches = k2.line_search.launches = _k8().launches = 0
    _zero_k9()
    counts = []
    outs = {}
    for b in FLEET_SIZES:
        before = (rs.riccati_sweep.launches, k2.line_search.launches, _k8().launches)
        outs[b] = ctrl(*inputs[b])
        counts.append((rs.riccati_sweep.launches - before[0], k2.line_search.launches - before[1],
                       _k8().launches - before[2]))
    torch.cuda.synchronize()
    launches = rs.riccati_sweep.launches
    _k2_count("fleet_solves_2x5_B256_4096_16384", k2.line_search.launches, k8=_k8().launches,
              solves=len(FLEET_SIZES))

    _check(counts == [(per_solve, per_solve, per_solve)] * len(FLEET_SIZES),
           f"(K1, K2, K8) launches per solve {counts}, expected {per_solve} each")
    for b in FLEET_SIZES:
        grf, cost = outs[b]
        _check(tuple(grf.shape) == (b, 4, 3) and tuple(cost.shape) == (b,), "output shapes")
        _check(bool(torch.isfinite(grf).all() and torch.isfinite(cost).all()), f"B={b} non-finite")
        mean_fz = grf[..., 2].sum(-1).mean().item()
        _check(abs(mean_fz - GO1_WEIGHT_N) <= 10.0,
               f"B={b} mean Σfz {mean_fz:.2f} N, expected {GO1_WEIGHT_N:.2f} ± 10")
        print(f"[main] f32 B={b}: K1, K2 and K8 launches {per_solve} each, mean Σfz {mean_fz:.3f} N, "
              f"mean cost {cost.mean().item():.5f}")

    # f64 on the card (kernel) against the CPU (plain sweep), same controller
    b = 256
    g_cuda, c_cuda = ctrl(*examples.standing_batch(b, HORIZON, torch.float64, device))
    g_cpu, c_cpu = ctrl(*examples.standing_batch(b, HORIZON, torch.float64, "cpu"))
    grf_err = (g_cuda.cpu() - g_cpu).abs().max().item()
    cost_err = (c_cuda.cpu() - c_cpu).abs().max().item()
    # the reference's bounds for reordered ops through 10 iLQR iterations
    _check(grf_err <= 1e-5 and cost_err <= 1e-7,
           f"f64 cuda vs cpu: grf {grf_err:.3e} (tol 1e-5), cost {cost_err:.3e} (tol 1e-7)")
    print(f"[main] f64 B={b} cuda vs cpu: max|GRF err| {grf_err:.3e} N, max|cost err| {cost_err:.3e}")
    return ctrl, inputs, launches


def phase_fixture(device):
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.control import quat_mpc
    from quaternion_mpc_tpu_torch.solver.fleet import make_fleet_solver
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    opts = SolverOptions()
    per_solve = opts.al_iterations * opts.ilqr_iterations
    solver = make_fleet_solver(quat_mpc._fleet_spec(), opts)
    b = 256
    prob, gold_us, gold_xs = examples.fixture_fleet_problem(b, torch.float32, device)
    sol = _counted(lambda: solver(prob), f"f32 fixture B={b}", per_solve, per_solve,
                   path="fixture_fleet_6x10_B256_f32_f64", solves=1)[0]
    gold_cost = examples.fixture_gold_cost(gold_us, gold_xs)
    cost = sol.cost.double().cpu().numpy()
    u0 = sol.us[0].double().cpu().numpy().T
    cost_err = float(np.max(np.abs(cost - gold_cost)))
    u0_err = float(np.max(np.abs(u0 - gold_us[0][None, :])))
    _check(
        bool(np.all(np.isfinite(cost)))
        and cost_err <= 5e-3 * max(abs(gold_cost), 1e-6) + 1e-6
        and u0_err <= 0.5,
        f"f32 fixture guard: cost err {cost_err:.3e} vs golden {gold_cost:.6e}, u0 err {u0_err:.3e}",
    )
    print(f"[fixture] f32 B={b}: u0 err {u0_err:.3e} N (tol 0.5), cost err {cost_err:.3e} "
          f"vs golden {gold_cost:.6e} (rtol 5e-3)")

    prob, gold_us, gold_xs = examples.fixture_fleet_problem(b, torch.float64, device)
    sol = _counted(lambda: solver(prob), f"f64 fixture B={b}", per_solve, per_solve,
                   path="fixture_fleet_6x10_B256_f32_f64", solves=1)[0]
    us_err = float(np.max(np.abs(sol.us.cpu().numpy().transpose(2, 0, 1) - gold_us)))
    xs_err = float(np.max(np.abs(sol.xs.cpu().numpy().transpose(2, 0, 1) - gold_xs)))
    _check(us_err <= 1e-4 and xs_err <= 1e-5,
           f"f64 fixture: us err {us_err:.3e} (tol 1e-4), xs err {xs_err:.3e} (tol 1e-5)")
    print(f"[fixture] f64 B={b}: us err {us_err:.3e} (tol 1e-4), xs err {xs_err:.3e} (tol 1e-5)")


def phase_assoc_quality(device):
    """The fixture through the associative scan: the f32 guard at B=1 under
    the default backend ("auto" sends one robot to K4), and the f64 fixture
    at B=4 under backend="assoc", us within 1e-3 (the reference's
    test_parallel_riccati.py:72-83)."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.control import quat_mpc
    from quaternion_mpc_tpu_torch.kernels import assoc_scan as k4
    from quaternion_mpc_tpu_torch.kernels import line_search as k2
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs
    from quaternion_mpc_tpu_torch.solver.fleet import make_fleet_solver
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    opts = SolverOptions()
    per_solve = opts.al_iterations * opts.ilqr_iterations
    prob, gold_us, gold_xs = examples.fixture_fleet_problem(1, torch.float32, device)
    k4.assoc_backward.launches = k4.assoc_scan.launches = rs.riccati_sweep.launches = 0
    k2.line_search.launches = _k8().launches = 0
    _zero_k9()
    sol = make_fleet_solver(quat_mpc._fleet_spec(), opts)(prob)
    torch.cuda.synchronize()
    counts = (k4.assoc_backward.launches, k4.assoc_scan.launches, rs.riccati_sweep.launches,
              k2.line_search.launches)
    _check(counts == (per_solve, 0, 0, per_solve),
           f"auto B=1: (assoc_backward, assoc_scan, K1, K2) launches {counts}, expected "
           f"({per_solve}, 0, 0, {per_solve})")
    _k2_count("fixture_assoc_6x10_B1_B4", counts[3], k8=_k8().launches, solves=1)
    gold_cost = examples.fixture_gold_cost(gold_us, gold_xs)
    cost = sol.cost.double().cpu().numpy()
    u0 = sol.us[0].double().cpu().numpy().T
    cost_err = float(np.max(np.abs(cost - gold_cost)))
    u0_err = float(np.max(np.abs(u0 - gold_us[0][None, :])))
    _check(
        bool(np.all(np.isfinite(cost)))
        and cost_err <= 5e-3 * max(abs(gold_cost), 1e-6) + 1e-6
        and u0_err <= 0.5,
        f"assoc f32 guard: cost err {cost_err:.3e} vs golden {gold_cost:.6e}, u0 err {u0_err:.3e}",
    )
    print(f"[fixture] assoc (auto) f32 B=1: K4, K2 and K8 launches {per_solve} each, u0 err {u0_err:.3e} N "
          f"(tol 0.5), cost err {cost_err:.3e} vs golden {gold_cost:.6e} (rtol 5e-3)")

    prob, gold_us, _ = examples.fixture_fleet_problem(4, torch.float64, device)
    k2.line_search.launches = _k8().launches = 0
    _zero_k9()
    sol = make_fleet_solver(quat_mpc._fleet_spec(), opts, backend="assoc")(prob)
    torch.cuda.synchronize()
    _check(k2.line_search.launches == per_solve,
           f"assoc f64 B=4: K2 launches {k2.line_search.launches}, expected {per_solve}")
    _k2_count("fixture_assoc_6x10_B1_B4", k2.line_search.launches, k8=_k8().launches, solves=1)
    us = sol.us.cpu().numpy().transpose(2, 0, 1)
    us_err = float(np.max(np.abs(us - gold_us)))
    _check(bool(np.all(np.isfinite(us))) and us_err <= 1e-3,
           f"assoc f64 fixture: us err {us_err:.3e} (tol 1e-3)")
    print(f"[fixture] assoc f64 B=4: us err {us_err:.3e} (tol 1e-3)")


def phase_timing(ctrl, inputs):
    step = {}
    for b in FLEET_SIZES:
        step[b] = t = _sync_time(lambda: ctrl(*inputs[b]))
        print(f"[timing] controller step f32 B={b}: p50 {t * 1e3:.3f} ms, {b / t:,.0f} solves/s")
    return step


# K1 alone: (dtype, N, B), the first the main path's shape.
K1_TIMED = (
    (torch.float32, HORIZON, 4096), (torch.float32, HORIZON, 1), (torch.float32, HORIZON, 256),
    (torch.float32, HORIZON, 16384), (torch.float32, 20, 1), (torch.float64, HORIZON, 4096),
)


def _shape_tag(dtype, horizon, batch):
    return f"{'f32' if dtype == torch.float32 else 'f64'} N={horizon} B={batch}"


def phase_sweep_timing(device):
    """K1 alone at K1_TIMED on the main path's expansions (at B=4096 and
    above they exceed the L2 cache; below, the solver too hands them over
    from the launches just before): CUDA events around a replayed graph of
    50 launches ("ms"), around 50 eager launches ("eager_ms", which is the
    host's enqueue cost where that is the longer), the host's time in one
    call of the wrapper, each beside the bound; the plain sweep at the main
    path's shape and at B=1. Returns {shape: {"ms", "eager_ms",
    "host_enqueue_ms", "bound_ms", "bound_by", "share_of_bound"[,
    "plain_ms"]}}."""
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    by_shape = {}
    for dtype, horizon, batch in K1_TIMED:
        args = _sweep_inputs(batch, dtype, device, horizon)
        launch = lambda: rs.riccati_sweep(*args)
        ms = _graph_time(launch, reps=50) * 1e3
        eager_ms = _event_time(launch, reps=50) * 1e3
        host_ms = _enqueue_time(launch) * 1e3
        bound_ms, bound_by = _bound(rs.work(horizon, batch, dtype), dtype)
        entry = {"ms": ms, "eager_ms": eager_ms, "host_enqueue_ms": host_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "share_of_bound": bound_ms / ms}
        line = (f"[timing] K1 riccati_sweep {_shape_tag(dtype, horizon, batch)}: kernel {ms:.4f} ms "
                f"(graph replay; {eager_ms:.4f} ms eager, host {host_ms:.4f} ms a call), "
                f"bound {bound_ms:.5f} ms by {bound_by} ({100 * bound_ms / ms:.2f}% of it reached)")
        if dtype == torch.float32 and horizon == HORIZON and batch in (1, 4096):
            entry["plain_ms"] = _event_time(lambda: rs.riccati_sweep_ref(*args), reps=5) * 1e3
            line += f", plain {entry['plain_ms']:.3f} ms"
        print(line)
        by_shape[_shape_tag(dtype, horizon, batch)] = entry
        del args
    return by_shape


def phase_scan_timing(device):
    """K4's two entries alone, f32, at K4_TIMED, and K1 on the same problems'
    expansions (the backward kernel "sweep" runs instead): CUDA events around
    a replayed graph of 50 launches (the plain versions: eager launches),
    each entry beside its bound. Returns ({tag: {"ms", "plain_ms",
    "bound_ms", "bound_by", "k1_ms"}} of the scan, the same of the fused
    entry)."""
    from quaternion_mpc_tpu_torch.kernels import assoc_scan as k4
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    scan, fused = {}, {}
    for tag, sweep_args, elems in _scan_cases(torch.float32, device, only=K4_TIMED):
        n1, batch = elems[0].shape[0], elems[0].shape[-1]
        k1_ms = _graph_time(lambda: rs.riccati_sweep(*sweep_args), reps=50) * 1e3
        for name, kernel, plain, args, work, times in (
                ("assoc_scan", k4.assoc_scan, k4.assoc_scan_ref, elems,
                 k4.work(n1, batch, torch.float32), scan),
                ("assoc_backward", k4.assoc_backward, k4.assoc_backward_ref, sweep_args,
                 k4.work_backward(n1 - 1, batch, torch.float32), fused)):
            ms = _graph_time(lambda: kernel(*args), reps=50) * 1e3
            plain_ms = _event_time(lambda: plain(*args), reps=5) * 1e3
            bound_ms, bound_by = _bound(work, torch.float32)
            times[tag] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "k1_ms": k1_ms}
            print(f"[timing] K4 {name} f32 {tag}: kernel {ms:.4f} ms, bound {bound_ms:.6f} ms "
                  f"by {bound_by}, plain {plain_ms:.3f} ms; K1 riccati_sweep on the same "
                  f"problem {k1_ms:.4f} ms")
    return scan, fused


# The B=1 latency rows of the reference's bench (bench.py:484-495): label,
# horizon, solver options, carry us_init, carry lam_init.
def _latency_rows():
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    cold = SolverOptions(al_iterations=2, ilqr_iterations=5)
    rti = SolverOptions(al_iterations=1, ilqr_iterations=3, penalty_initial=10.0)
    rti2 = SolverOptions(al_iterations=1, ilqr_iterations=2, penalty_initial=10.0)
    return [
        ("N=10 cold 2x5", 10, cold, False, False),
        ("N=20 cold 2x5", 20, cold, False, False),
        ("N=10 warm RTI 1x3", 10, rti, True, False),
        ("N=20 warm RTI 1x3", 20, rti, True, False),
        ("N=10 dual-warm RTI 1x2", 10, rti2, True, True),
    ]


def _ticks(ctrl, inputs, n_ticks, warm, dual):
    """One untimed tick, then n_ticks timed ticks of build + solve, each
    ending in a synchronize; warm ticks carry the previous solution's us
    (and lam). Returns the tick times in seconds."""
    us = lam = None
    times = []
    for i in range(n_ticks + 1):
        t0 = time.perf_counter()
        _, _, sol = ctrl(*inputs, us_init=us, lam_init=lam)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
        if warm:
            us = torch.movedim(sol.us, -1, 0)
        if dual:
            lam = torch.movedim(sol.lam, -1, 0)
    return times


def phase_latency(device):
    """Single-robot latency at B=1, f32: per row, backend "auto" (the
    associative scan, K4's fused entry) and "sweep" (K1) in turns (auto,
    sweep, sweep, auto; 5 timed ticks each). Checks that each tick launches
    its kernel al x ilqr times and the other kernel, and `assoc_scan`, never.
    Returns the rows and, of the auto runs, the launches of K4's fused entry
    and of `assoc_scan`."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.control import quat_mpc
    from quaternion_mpc_tpu_torch.kernels import assoc_scan as k4
    from quaternion_mpc_tpu_torch.kernels import line_search as k2
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    kernel_of = {"auto": k4.assoc_backward, "sweep": rs.riccati_sweep}
    rows, k4_launches, scan_launches = [], 0, 0
    for label, horizon, opts, warm, dual in _latency_rows():
        per_tick = opts.al_iterations * opts.ilqr_iterations
        inputs = examples.standing_batch(1, horizon, torch.float32, device)
        ctrls = {b: quat_mpc.make_fleet_controller(horizon, opts, backend=b, return_sol=True)
                 for b in kernel_of}
        times = {b: [] for b in kernel_of}
        for backend in ("auto", "sweep", "sweep", "auto"):
            k4.assoc_backward.launches = k4.assoc_scan.launches = rs.riccati_sweep.launches = 0
            k2.line_search.launches = _k8().launches = 0
            _zero_k9()
            n = LATENCY_TICKS // 2
            times[backend] += _ticks(ctrls[backend], inputs, n, warm, dual)
            counts = {b: kernel_of[b].launches for b in kernel_of}
            want = {b: (n + 1) * per_tick if b == backend else 0 for b in kernel_of}
            _check(counts == want and k4.assoc_scan.launches == 0
                   and k2.line_search.launches == (n + 1) * per_tick,
                   f"{label} {backend}: launches {counts} (assoc_scan "
                   f"{k4.assoc_scan.launches}, K2 {k2.line_search.launches}), expected {want} "
                   f"(0, {(n + 1) * per_tick})")
            _k2_count("latency_rows_B1_auto_and_sweep", k2.line_search.launches,
                      k8=_k8().launches, solves=n + 1)
            if backend == "auto":
                k4_launches += counts["auto"]
                scan_launches += k4.assoc_scan.launches
        p50 = {b: statistics.median(t) * 1e3 for b, t in times.items()}
        rows.append((label, p50["auto"], p50["sweep"]))
        print(f"[latency] B=1 f32 {label}: p50 {p50['auto']:.2f} ms/tick auto (K4, "
              f"{per_tick} launches/tick), {p50['sweep']:.2f} ms/tick sweep (K1, "
              f"{per_tick} launches/tick), K2 {per_tick} launches/tick under both; "
              f"{LATENCY_TICKS} ticks each")
    return rows, k4_launches, scan_launches


def phase_convex(device):
    """The Euler convex-MPC fleet baseline (bench.py:347-358): N=10, 1 AL x
    5 iLQR, 8 alphas, B=4096 f32, exactly 5 K1 and 5 K2 launches a solve
    (K2's Euler-SRB instantiation under the midpoint rule), fleet mean Σfz
    within 10 N of the weight (printed beside the mean of the same solve with
    the plain line search), p50 step and the device operations of one traced
    step; then f64 at B=256 on the card against the CPU (the quaternion
    path's bounds). Returns the p50 seconds and the K1 launches of the
    B=4096 solve."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.control import convex_mpc
    from quaternion_mpc_tpu_torch.kernels import line_search as k2
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs
    from quaternion_mpc_tpu_torch.solver import fleet
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    opts = SolverOptions(al_iterations=1, ilqr_iterations=5, max_linesearch=8)
    per_solve = opts.al_iterations * opts.ilqr_iterations
    ctrl = convex_mpc.make_fleet_controller(HORIZON, opts)
    b = 4096
    inputs = examples.standing_batch(b, HORIZON, torch.float32, device, controller="convex")
    rs.riccati_sweep.launches = k2.line_search.launches = _k8().launches = 0
    _zero_k9()
    grf, cost = ctrl(*inputs)
    torch.cuda.synchronize()
    launches = rs.riccati_sweep.launches
    _check(launches == per_solve and k2.line_search.launches == per_solve,
           f"convex (K1, K2) launches per solve ({launches}, {k2.line_search.launches}), "
           f"expected ({per_solve}, {per_solve})")
    _k2_count("convex_fleet_1x5_B4096", k2.line_search.launches, "euler_srb_midpoint",
              k8=_k8().launches, solves=1)
    _check(tuple(grf.shape) == (b, 4, 3) and tuple(cost.shape) == (b,), "convex output shapes")
    _check(bool(torch.isfinite(grf).all() and torch.isfinite(cost).all()), "convex non-finite")
    mean_fz = grf[..., 2].sum(-1).mean().item()
    _check(abs(mean_fz - GO1_WEIGHT_N) <= 10.0,
           f"convex mean Σfz {mean_fz:.2f} N, expected {GO1_WEIGHT_N:.2f} ± 10")
    # the same solve with the plain line search (an untagged spec), for the record
    plain = fleet.make_fleet_solver(convex_mpc.FLEET_MODEL_SPEC._replace(line_search=None), opts)
    sol = plain(convex_mpc.build_fleet_problem(*inputs, HORIZON))
    plain_fz = sol.us[0].reshape(4, 3, b)[:, 2].sum(0).mean().item()
    step = _sync_time(lambda: ctrl(*inputs))
    print(f"[convex] f32 B={b}: K1, K2 and K8 launches {per_solve} each, mean Σfz {mean_fz:.4f} N "
          f"(the same solve with the plain line search: {plain_fz:.4f} N; weight "
          f"{GO1_WEIGHT_N:.2f} ± 10), mean cost {cost.mean().item():.5f}, step p50 "
          f"{step * 1e3:.3f} ms, {b / step:,.0f} solves/s")
    try:
        _profile_once(lambda: ctrl(*inputs), f"convex fleet step B={b}", step)
    except RuntimeError as e:  # a record, not a check: the tracer may be unavailable
        print(f"[profile] convex fleet step not measured: {e}")

    b = 256
    k2.line_search.launches = _k8().launches = 0
    _zero_k9()
    g_cuda, c_cuda = ctrl(*examples.standing_batch(b, HORIZON, torch.float64, device,
                                                   controller="convex"))
    torch.cuda.synchronize()
    _check(k2.line_search.launches == per_solve, f"convex f64: K2 launches "
                                                 f"{k2.line_search.launches}, expected {per_solve}")
    _k2_count("convex_fleet_1x5_B256_f64", k2.line_search.launches, "euler_srb_midpoint",
              k8=_k8().launches, solves=1)
    g_cpu, c_cpu = ctrl(*examples.standing_batch(b, HORIZON, torch.float64, "cpu",
                                                 controller="convex"))
    grf_err = (g_cuda.cpu() - g_cpu).abs().max().item()
    cost_err = (c_cuda.cpu() - c_cpu).abs().max().item()
    _check(grf_err <= 1e-5 and cost_err <= 1e-7,
           f"convex f64 cuda vs cpu: grf {grf_err:.3e} (tol 1e-5), cost {cost_err:.3e} (tol 1e-7)")
    print(f"[convex] f64 B={b} cuda vs cpu: max|GRF err| {grf_err:.3e} N, "
          f"max|cost err| {cost_err:.3e}")
    return step, launches


def _ranges(events):
    """The names of a trace's profiler ranges (`record_function`). A range is
    also recorded on the device, as an annotation spanning its kernels: no
    kernel, and no device time of its own."""
    return {e.name for e in events if getattr(e, "is_user_annotation", False)}


def _profile_once(fn, tag, unprofiled_s):
    """Device time by kernel name over one call of fn, for the record; the
    busy share is against the unprofiled p50 time ``unprofiled_s``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ranges = _ranges(prof.events())
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in ranges]
    dev_ms = lambda e: e.device_time_total / 1e3
    busy = sum(dev_ms(e) for e in kernels)
    if busy <= 0:
        print(f"[profile] {tag}: the trace holds no device time: not measured")
        return None
    kernels.sort(key=dev_ms, reverse=True)
    top = "; ".join(f"{e.key[:60]} {dev_ms(e):.2f} ms x{e.count}" for e in kernels[:10])
    print(f"[profile] {tag}: device busy {busy:.2f} ms = {100 * busy / (unprofiled_s * 1e3):.1f}% "
          f"of the unprofiled p50 (profiled wall {wall_ms:.1f} ms), "
          f"{sum(e.count for e in kernels)} kernel launches; by kernel: {top}")
    return sum(e.count for e in kernels)


def phase_profile(ctrl, inputs, step_s, latency, device):
    """One B=4096 quaternion step (returned: its device ops and busy time,
    and its `expansions` ranges, with those of its solve on one problem with
    the expansions by K8 and by the plain version), and one B=1 N=10 cold
    tick under each backend (against the latency rows' p50). After the expansions the assoc
    backward pass is one launch, as the sweep is, so the two ticks' launch
    counts must lie within 100 of each other. A trace can lose device
    records (one of five runs read 159 fewer kernels under "auto" than the
    21,541 of every other trace) and never invents one, so a pair further
    apart is traced once more and each backend keeps its larger count."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.control import quat_mpc
    from quaternion_mpc_tpu_torch.solver import fleet
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    ranges = (fleet.EXPANSIONS, fleet.OPEN_LOOP, fleet.PRICING)
    step_profile = _profile_tick(lambda: ctrl(*inputs[4096]), step_s, "B=4096 step", ranges)
    # the main path's solve on one problem, its expansions by K8 and by the
    # plain version (an untagged spec), and its open-loop rollout and
    # pricings by K9 and by the plain versions (a spec without K2's tag):
    # the ranges before and after
    prob = quat_mpc.build_fleet_problem(*inputs[4096], HORIZON)
    solve_opts = SolverOptions(al_iterations=2, ilqr_iterations=5, max_linesearch=8)
    for how, spec in (("K8", quat_mpc.FLEET_MODEL_SPEC),
                      ("plain", quat_mpc.FLEET_MODEL_SPEC._replace(expansions=None)),
                      ("plain K9 regions", quat_mpc.FLEET_MODEL_SPEC._replace(line_search=None))):
        solve = fleet.make_fleet_solver(spec, solve_opts)
        got = _profile_tick(lambda: solve(prob), _sync_time(lambda: solve(prob), runs=5),
                            f"B=4096 2x5 solve, expansions by {how}", ranges)
        if step_profile is not None and got is not None:
            step_profile[f"solve_expansions_by_{how}"] = dict(
                device_ops=got["device_ops"], device_busy_ms=got["device_busy_ms"],
                **{name: got["split"].get(name) for name in ranges})
    label, _, opts, _, _ = _latency_rows()[0]
    p50 = {"auto": latency[0][1], "sweep": latency[0][2]}
    one = examples.standing_batch(1, 10, torch.float32, device)
    ticks = {b: quat_mpc.make_fleet_controller(10, opts, backend=b) for b in p50}
    launches = {}
    for _ in range(2):
        for backend, ms in p50.items():
            got = _profile_once(lambda: ticks[backend](*one), f"B=1 {label} tick, {backend}",
                                ms / 1e3)
            launches[backend] = got if got is None else max(got, launches.get(backend) or 0)
        if None in launches.values() or abs(launches["auto"] - launches["sweep"]) <= 100:
            break
    if None not in launches.values():
        print(f"[profile] B=1 {label} tick: {launches['auto']} launches under auto, "
              f"{launches['sweep']} under sweep")
        _check(abs(launches["auto"] - launches["sweep"]) <= 100,
               f"auto and sweep ticks differ by more than 100 launches: {launches}")
    return step_profile


CLOSED_LOOP_B = 4096
STAND_TICKS = 50
WALK_TICKS = 300
WALK_TAIL = 150  # ticks the tracking bounds average over (test_walking.py:86-88)
# f64 card vs CPU over 10 walking RTI ticks at B=64: GRFs within the repo's
# 1e-5 N bound for reordered ops (phase 4), plant state within 1e-8. The same
# ticks through the JAX package and the port on the CPU (two op orders)
# differ by 2.0e-8 N and 3.8e-10 (PERF.md, the closed-loop entry).
F64_GRF_TOL, F64_PLANT_TOL = 1e-5, 1e-8


def _rti_opts():
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    # bench.py:402-406: the deployed fleet's budget
    return SolverOptions(al_iterations=1, ilqr_iterations=3, penalty_initial=10.0,
                         max_linesearch=8)


def _drive(step, carry, sp, joy, ticks, per_tick, what, sync=False, ext=None, path=None,
           k10=0, k11=1):
    """``ticks`` ticks of a quaternion-SRB fleet step, checking that each
    launches K1 and K4's fused entry exactly ``per_tick`` = (k1, k4) times,
    K2 and K8 once an iLQR iteration (k1 + k4 times each), K10 ``k10``
    times (1: a walking step's pre), K11 ``k11`` times (1: every SRB step's
    post), and `assoc_scan` never. The counts are set to 0 just before and
    read just after; ``path`` names the run's K2 and K8 launches in the
    kernels line, ``what`` its K10 and K11 launches. Returns (carry, metrics
    of every tick, tick seconds when ``sync``, (K1, K4, K2) launches per
    tick)."""
    from quaternion_mpc_tpu_torch.kernels import assoc_scan as k4
    from quaternion_mpc_tpu_torch.kernels import line_search as k2
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    rs.riccati_sweep.launches = k4.assoc_backward.launches = k4.assoc_scan.launches = 0
    k2.line_search.launches = _k8().launches = _k10().launches = _k11().launches = 0
    _zero_k9()
    want = (*per_tick, sum(per_tick), sum(per_tick), k10, k11)
    metrics, times = [], []
    for tick in range(ticks):
        before = (rs.riccati_sweep.launches, k4.assoc_backward.launches, k2.line_search.launches,
                  _k8().launches, _k10().launches, _k11().launches)
        t0 = time.perf_counter()
        carry, m = step(carry, sp, joy, ext)
        if sync:
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        got = (rs.riccati_sweep.launches - before[0], k4.assoc_backward.launches - before[1],
               k2.line_search.launches - before[2], _k8().launches - before[3],
               _k10().launches - before[4], _k11().launches - before[5])
        _check(got == want,
               f"{what} tick {tick}: (K1, K4, K2, K8, K10, K11) launches {got}, expected {want}")
        metrics.append(m)
    torch.cuda.synchronize()
    _check(k4.assoc_scan.launches == 0, f"{what}: assoc_scan launched on the solver's path")
    if path is not None:
        _k2_count(path, k2.line_search.launches, k8=_k8().launches, solves=ticks)
    _k10_count(what, _k10().launches)
    _k11_count(what, _k11().launches)
    per = (rs.riccati_sweep.launches / ticks, k4.assoc_backward.launches / ticks,
           k2.line_search.launches / ticks)
    return carry, metrics, times, per


def _all_finite(tree):
    from quaternion_mpc_tpu_torch.utils.tree import tree_leaves

    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree) if t.is_floating_point())


def phase_standing_fleet(device):
    """The CLI's standing fleet at B=4096: 50 ticks of the 2 x 5 step."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    b = CLOSED_LOOP_B
    opts = SolverOptions(al_iterations=2, ilqr_iterations=5)
    per_tick = opts.al_iterations * opts.ilqr_iterations
    step = rt.make_fleet_standing_step(HORIZON, opts)
    carry, sp, joy = examples.standing_fleet(b, torch.float32, device)
    carry, metrics, times, per = _drive(step, carry, sp, joy, STAND_TICKS, (per_tick, 0),
                                        "standing", sync=True, path="standing_fleet_2x5_B4096")
    _check(bool(carry.alive.all()), f"standing: {int((~carry.alive).sum())} robots down")
    _check(_all_finite(carry), "standing: non-finite state")
    h_err = metrics[-1].height_err.mean().item()
    _check(h_err <= 0.02, f"standing: final mean height error {h_err:.4f} m > 0.02")
    p50 = statistics.median(times[1:])
    print(f"[closed-loop] standing fleet f32 B={b}, 2x5, {STAND_TICKS} ticks: K1 launches "
          f"{per_tick}/tick, K4 0, all alive, final mean height_err {h_err:.5f} m, "
          f"att_err {metrics[-1].att_err.mean().item():.2e}; p50 {p50 * 1e3:.2f} ms/tick "
          f"({b / p50:,.0f} robot-ticks/s)")
    return p50, per


def _walk_300(step, dtype, device, what, moved=0.0):
    """WALK_TICKS ticks of the walking RTI fleet at 0.4 m/s, replayed from a
    CUDA graph of ``step`` as `cli run_trot` replays it, exactly al x ilqr K1
    launches a tick and no K4; ``moved``: each robot's start position
    moved by seeded normal noise of that many metres. Returns (carry,
    per-robot mean vel_err and height_err over the last WALK_TAIL ticks,
    (K1, K4, K2) launches per tick, ms per tick of the run with one sync at
    its end)."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.utils.graphs import Graphed

    opts = _rti_opts()
    per_tick = opts.al_iterations * opts.ilqr_iterations
    carry, sp, joy = examples.walking_batch(CLOSED_LOOP_B, HORIZON, dtype, device, velx=0.4)
    if moved:
        noise = np.random.default_rng(11).standard_normal((CLOSED_LOOP_B, 3))
        pos = carry.plant.pos + torch.from_numpy(moved * noise).to(device, dtype)
        carry = carry._replace(plant=carry.plant._replace(pos=pos))
    # as the CLI's closed loop runs it: the tick a CUDA graph, replayed with
    # the carry chained in its buffers (captured before the counts start)
    graph = Graphed(step, chain=True)
    graph.captured(carry, sp, joy, None)
    t0 = time.perf_counter()
    carry, metrics, _, per = _drive(graph, carry, sp, joy, WALK_TICKS, (per_tick, 0), what,
                                    k10=1)
    ms = (time.perf_counter() - t0) / WALK_TICKS * 1e3
    tail = metrics[-WALK_TAIL:]
    vel_err = torch.stack([m.vel_err for m in tail]).mean(0)
    h_err = torch.stack([m.height_err for m in tail]).mean(0)
    return carry, vel_err, h_err, per, ms


def _hold_walking(carry, vel_err, h_err, per_tick, ms, what):
    """test_walking.py's RTI bounds (:68-88) in every robot of a 300-tick run."""
    x = carry.plant.pos[:, 0]
    _check(bool(carry.alive.all()), f"{what}: {int((~carry.alive).sum())} robots down")
    _check(_all_finite(carry.plant), f"{what}: non-finite state")
    _check(x.min().item() > 0.9, f"{what}: min x {x.min().item():.3f} m <= 0.9")
    _check(vel_err.max().item() < 0.05, f"{what}: max vel_err {vel_err.max().item():.4f} >= 0.05")
    _check(h_err.max().item() < 0.01, f"{what}: max height_err {h_err.max().item():.4f} >= 0.01")
    print(f"[closed-loop] {what} B={CLOSED_LOOP_B}, 1x3, {WALK_TICKS} ticks at 0.4 m/s: "
          f"K1 launches {per_tick}/tick, K4 0, all alive; x {x.min().item():.4f}-"
          f"{x.max().item():.4f} m; last {WALK_TAIL} ticks' vel_err up to "
          f"{vel_err.max().item():.5f} m/s, height_err up to {h_err.max().item():.5f} m; "
          f"{ms:.2f} ms/tick over the run (one sync at its end)")


def _walking_quality(step, dtype, device):
    """One 300-tick walking run held to its bounds; returns (K1, K4)
    launches per tick."""
    what = f"walking RTI fleet {str(dtype)[6:]}"
    carry, vel_err, h_err, per, ms = _walk_300(step, dtype, device, what)
    opts = _rti_opts()
    _hold_walking(carry, vel_err, h_err, opts.al_iterations * opts.ilqr_iterations, ms, what)
    return per


def phase_walking_fleet(device):
    """The bench's walking RTI fleet at B=4096, f32: the p50 tick at the
    bench's 0.3 m/s, exactly 3 K1 launches a tick. Its 300-tick quality runs
    at 0.4 m/s, held to test_walking.py's RTI bounds in every robot in f32
    (the fleet a user runs) and in f64, are the workers "walking-f32" and
    "walking-f64" beside phase 11 (the reference's f32 loop is marginal: on
    the CPU the JAX package's own f32 fleet falls or misses the bounds at
    some fleet sizes; f64 is not, so a miss in f32 alone points at rounding,
    one in both at the port; the worker "walking-f32-moved" prints, not
    holds, how many robots stand when each start is moved by 1e-6 m).
    Returns (f32 step, carry, sp, joy, p50 seconds, (K1, K4, K2) launches
    per tick of the timed ticks)."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.runtime import step as rt

    b = CLOSED_LOOP_B
    opts = _rti_opts()
    per_tick = opts.al_iterations * opts.ilqr_iterations
    step = rt.make_fleet_walking_step(HORIZON, opts, warm_start=True)
    timed = examples.walking_batch(b, HORIZON, torch.float32, device, velx=0.3)
    c, _, _, _ = _drive(step, *timed, 3, (per_tick, 0), "walking settle",
                        path="walking_rti_1x3_B4096", k10=1)
    _, _, times, per = _drive(step, c, timed[1], timed[2], 10, (per_tick, 0), "walking timed",
                              sync=True, path="walking_rti_1x3_B4096", k10=1)
    p50 = statistics.median(times)
    print(f"[closed-loop] walking RTI fleet f32 B={b} at 0.3 m/s: p50 {p50 * 1e3:.2f} ms/tick "
          f"over 10 ticks after 3 settle ticks, {b / p50:,.0f} solves/s")
    return step, c, timed[1], timed[2], p50, per


def phase_walking_one_robot(device):
    """One walking robot under backend "auto": K4, not K1, every tick."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.runtime import step as rt

    opts = _rti_opts()
    per_tick = opts.al_iterations * opts.ilqr_iterations
    step = rt.make_fleet_walking_step(HORIZON, opts, warm_start=True)
    carry, sp, joy = examples.walking_batch(1, HORIZON, torch.float32, device, velx=0.4)
    carry, _, times, per = _drive(step, carry, sp, joy, 20, (0, per_tick), "walking B=1",
                                  sync=True, path="walking_rti_1x3_B1", k10=1)
    _check(bool(carry.alive.all()) and _all_finite(carry.plant), "walking B=1: robot down")
    p50 = statistics.median(times[1:])
    print(f"[closed-loop] walking RTI f32 B=1 (auto): K4 launches {per_tick}/tick, K1 0, "
          f"alive at x {carry.plant.pos[0, 0].item():.4f} m after 20 ticks; p50 "
          f"{p50 * 1e3:.2f} ms/tick")
    return p50, per


# The reference's stairs gate (tests/test_terrain_walking.py:43-52): one
# robot from `init_walking_scenario` on stairs of 0.17 m rise and 0.30 m run,
# the per-scenario walking step at horizon 10, 2 AL x 4 iLQR, 0.3 m/s, 400
# ticks; then alive, x > 0.7 m and z > 0.55 m
STAIRS_TICKS = 400
STAIRS_RISE, STAIRS_RUN, STAIRS_VELX = 0.17, 0.30, 0.3
STAIRS_MIN_X, STAIRS_MIN_Z = 0.7, 0.55


def phase_stairs_gate(device):
    """The reference's stairs gate through the port's per-scenario walking
    step (`make_walking_step`) replayed from a CUDA graph, STAIRS_TICKS
    replays each launching K1, K2 and K8 al x ilqr times, K9's rollout once
    and its pricing al + 1 times, K10 and K11 once: f64 must hold the gate's
    bounds; the f32 walk's outcome is printed, not held. Returns {dtype
    name: {"alive", "x", "z", "first_tick_down"}}."""
    from quaternion_mpc_tpu_torch.control import quat_mpc
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.sim import terrain as terrain_mod
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions
    from quaternion_mpc_tpu_torch.utils import config as cfg
    from quaternion_mpc_tpu_torch.utils.graphs import Graphed

    opts = SolverOptions(al_iterations=2, ilqr_iterations=4)
    want = _per_replay(opts.al_iterations, opts.ilqr_iterations, k10=1, k11=1)
    out = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        t0 = time.perf_counter()
        wts = quat_mpc.weights_from_config(cfg.gazebo_go1_quat_mpc(), dtype=dtype, device=device)
        tp = terrain_mod.make_terrain("stairs", stair_rise=STAIRS_RISE, stair_run=STAIRS_RUN,
                                      dtype=dtype, device=device)
        carry, sp = rt.init_walking_scenario(wts, dtype=dtype, terrain=tp, device=device)
        joy = rt.neutral_joy(dtype, device)._replace(
            velx=torch.full((), STAIRS_VELX, dtype=dtype, device=device))
        graph = Graphed(rt.make_walking_step(HORIZON, opts), chain=True)
        _hold_graph(graph.captured(carry, sp, joy), f"stairs gate {name}", want)
        _zero_counts()
        alive = []
        for _ in range(STAIRS_TICKS):
            carry, _ = graph(carry, sp, joy)
            alive.append(carry.alive.clone())  # the chain's state is the graph's buffer
        torch.cuda.synchronize()
        c = _counts()
        _check(all(c[k] == n * STAIRS_TICKS for k, n in want.items()),
               f"stairs gate {name}: launches {c} over {STAIRS_TICKS} replays, expected {want} "
               f"each")
        _k2_count(f"stairs_gate_{name}_2x4_B1", c["line_search"], k8=c["knot_expansions"],
                  k9=(c["rollout"], c["price"]), solves=STAIRS_TICKS)
        _k10_count(f"graphed stairs gate {name}", c["walking_pre"])
        _k11_count(f"graphed stairs gate {name}", c["srb_post"])
        up = torch.stack(alive).cpu()
        down = (~up).nonzero()
        res = {"alive": bool(up[-1]), "x": carry.plant.pos[0].item(),
               "z": carry.plant.pos[2].item(),
               "first_tick_down": int(down[0, 0]) if len(down) else None}
        out[name] = res
        print(f"[stairs] {name}: the reference's stairs gate (rise {STAIRS_RISE} m, run "
              f"{STAIRS_RUN} m, {STAIRS_VELX} m/s, 2x4, {STAIRS_TICKS} ticks) through the graphed "
              f"per-scenario walking step: alive {res['alive']}, x {res['x']:.4f} m (> "
              f"{STAIRS_MIN_X}), z {res['z']:.4f} m (> {STAIRS_MIN_Z}), first tick down "
              f"{res['first_tick_down']}; {time.perf_counter() - t0:.1f} s")
    f64 = out["float64"]
    _check(f64["alive"] and f64["x"] > STAIRS_MIN_X and f64["z"] > STAIRS_MIN_Z,
           f"the f64 walk fails the reference's stairs gate: {f64}")
    return out


def _no_sync_tick(tick, what, tag):
    """One tick (``tick()``) with every synchronising CUDA call an error."""
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = tick()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    body = out.plant if hasattr(out, "plant") else out.robot  # the SRB / articulated carries
    _check(_all_finite(body) and _all_finite(getattr(out, "est", None)),
           f"sync-debug {what} tick: non-finite state")
    print(f"[{tag}] one {what} tick under set_sync_debug_mode('error'): no synchronising call")


def phase_no_host_sync(step, carry, sp, joy):
    """One B=4096 walking tick that must not return to the host."""
    _no_sync_tick(lambda: step(carry, sp, joy), f"B={carry.alive.shape[0]} walking",
                  "closed-loop")


def phase_walking_f64(device):
    """10 f64 walking RTI ticks at B=64 on the card against the CPU: a
    seeded velocity spread, robot 0 pushed by 20 N along x."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.sim.plant import ExtWrench
    from quaternion_mpc_tpu_torch.utils.tree import tree_leaves

    b = 64
    torch.set_num_threads(2)  # the CPU half runs beside the other workers
    step = rt.make_fleet_walking_step(HORIZON, _rti_opts(), warm_start=True)
    velx = 0.4 * np.random.default_rng(0).random(b)
    force = np.zeros((b, 3))
    force[0, 0] = 20.0
    runs = []  # the card's ticks, then the CPU's
    for dev in (device, torch.device("cpu")):
        carry, sp, joy = examples.walking_batch(b, HORIZON, torch.float64, dev)
        joy = joy._replace(velx=torch.from_numpy(velx).to(dev))
        ext = ExtWrench(force_world=torch.from_numpy(force).to(dev),
                        torque_body=torch.zeros((b, 3), dtype=torch.float64, device=dev))
        ticks = []
        for _ in range(10):
            carry, _ = step(carry, sp, joy, ext)
            ticks.append(carry)
        runs.append(ticks)
    grf_err = plant_err = 0.0
    for cu, cp in zip(*runs):
        grf_err = max(grf_err, (cu.us_prev[:, 0].cpu() - cp.us_prev[:, 0]).abs().max().item())
        plant_err = max(plant_err, max((a.cpu() - c).abs().max().item()
                                       for a, c in zip(tree_leaves(cu.plant), tree_leaves(cp.plant))))
        _check(torch.equal(cu.alive.cpu(), cp.alive), "f64 walking: alive differs card vs CPU")
    _check(grf_err <= F64_GRF_TOL and plant_err <= F64_PLANT_TOL,
           f"f64 walking card vs CPU: GRF {grf_err:.3e} (tol {F64_GRF_TOL}), plant "
           f"{plant_err:.3e} (tol {F64_PLANT_TOL})")
    print(f"[closed-loop] f64 walking RTI B={b}, 10 ticks, card vs CPU: max|GRF err| "
          f"{grf_err:.3e} N (tol {F64_GRF_TOL}), max|plant err| {plant_err:.3e} (tol "
          f"{F64_PLANT_TOL}), alive equal ({int(runs[0][-1].alive.sum())}/{b})")


def _launches_in(events, start, end):
    """CUDA launch calls on the host clock inside [start, end] (us)."""
    return sum(1 for e in events
               if e.name.startswith(("cudaLaunch", "cuLaunch"))
               and start <= e.time_range.start <= end)


def _profile_tick(tick, tick_s, what, ranges):
    """Device time by kernel over one fleet tick (``tick()``), and the tick's
    launches, host time and device time split between the step's profiler
    ``ranges`` (a range nested in another is counted in both; a range
    entered several times, as `expansions` once an iLQR iteration, sums its
    occurrences). The trace holds each range twice: on the host, and on the
    device as an annotation spanning its kernels (not device time itself); a
    range's device time is the kernels inside its spans."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tick()
        torch.cuda.synchronize()
    events = prof.events()
    annotations = _ranges(events) | set(ranges)
    on_device = [e for e in events if e.device_type == DeviceType.CUDA
                 and e.name not in annotations]
    busy = sum(e.time_range.elapsed_us() for e in on_device) / 1e3
    if busy <= 0:
        print(f"[profile] {what}: the trace holds no device time: not measured")
        return None
    split = {}
    for name in ranges:
        host = [e.time_range for e in events
                if e.name == name and e.device_type == DeviceType.CPU]
        span = [e.time_range for e in events
                if e.name == name and e.device_type == DeviceType.CUDA]
        if not host:
            continue
        part = dict(launches=sum(_launches_in(events, h.start, h.end) for h in host),
                    host_ms=sum(h.elapsed_us() for h in host) / 1e3, entered=len(host))
        if span:
            part["device_ms"] = sum(e.time_range.elapsed_us() for e in on_device
                                    if any(d.start <= e.time_range.start <= d.end
                                           for d in span)) / 1e3
            part["device_ops"] = sum(any(d.start <= e.time_range.start <= d.end for d in span)
                                     for e in on_device)
        split[name.split(".")[-1]] = part
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in annotations]
    kernels.sort(key=lambda e: e.device_time_total, reverse=True)
    top = "; ".join(f"{e.key[:60]} {e.device_time_total / 1e3:.2f} ms x{e.count}"
                    for e in kernels[:12])
    parts = ", ".join(
        f"{k} (x{v['entered']}) {v['launches']} launches / {v['host_ms']:.1f} ms host / "
        + (f"{v['device_ms']:.2f} ms device in {v['device_ops']} ops" if "device_ms" in v
           else "device not measured")
        for k, v in split.items())
    launches = _launches_in(events, -math.inf, math.inf)
    print(f"[profile] {what}: device busy {busy:.2f} ms = "
          f"{100 * busy / (tick_s * 1e3):.1f}% of the unprofiled p50, {len(on_device)} device "
          f"ops, {launches} launches; by range: {parts}; by kernel: {top}")
    return dict(device_busy_ms=busy, device_ops=len(on_device), launches=launches, split=split)


def profile_walking_tick(step, carry, sp, joy, tick_s):
    """One B=4096 walking tick, split between the step's pre / solve / post
    ranges and the solver's `expansions` (inside solve)."""
    from quaternion_mpc_tpu_torch.runtime import step as rt

    from quaternion_mpc_tpu_torch.solver import fleet

    return _profile_tick(lambda: step(carry, sp, joy), tick_s,
                         f"B={CLOSED_LOOP_B} walking RTI tick",
                         (rt.PRE, rt.SOLVE, rt.POST, fleet.EXPANSIONS, fleet.OPEN_LOOP,
                          fleet.PRICING))


# ---------------------------------------------------------------------------
# K10, the walking tick's pre (`kernels.walking_pre`): held against the
# plain version on the card, timed, and counted on the walking paths.
# ---------------------------------------------------------------------------

K10_TERRAINS = ("flat", "slope", "stairs")
K10_SNAPSHOTS = (100, 200, 300)  # the walks' ticks whose states K10 is held on
K10_EST_TICKS = 100
K10_CHECKED_B = (CLOSED_LOOP_B, 2048, 256, 64, 1)
K10_KF_TYPES = (0, 1, 2)
K10_KF_B = 64


def _k10_named(out):
    """The pre's eight outputs as (name, tensor) pairs."""
    names = ("fbk", "cmd", "goal", "gait", "plan_contacts", "foot_pos_body", "terr_est",
             "ground_z")

    def walk(tree, path):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return [x for f, v in zip(tree._fields, tree) for x in walk(v, f"{path}.{f}")]
        return [(path, tree)]

    return [x for name, part in zip(names, out) for x in walk(part, name)]


def _k10_hold(got, want, what):
    """K10's outputs against the plain version's, bit for bit in every
    output (NaN where the plain version has NaN): K10 follows the plain
    version's rounding on the card at every B of K10_CHECKED_B, each a batch
    at which `kernels.walking_pre.CUBLAS_ORDERS` was measured. Returns
    ({output: elements that differ} where any do, elements in all, the
    largest error relative to the output's scale, the largest absolute
    error), printed on a failure."""
    differ, total, worst, worst_abs = {}, 0, 0.0, 0.0
    for (name, g), (_, w) in zip(_k10_named(got), _k10_named(want)):
        _check(g.shape == w.shape and g.dtype == w.dtype, f"{what}: {name} shape or dtype")
        total += w.numel()
        if not w.is_floating_point():
            ne = int((g != w).sum())
        else:
            both_nan = torch.isnan(g) & torch.isnan(w)
            ne = int(((g != w) & ~both_nan).sum())
            d = torch.where(both_nan, 0.0, (g.double() - w.double()).abs())
            d = torch.nan_to_num(d, nan=math.inf)
            scale = torch.nan_to_num(w.double(), nan=0.0).abs().max().clamp(min=1e-300)
            if d.numel():
                worst = max(worst, float(d.max() / scale))
                worst_abs = max(worst_abs, float(d.max()))
        if ne:
            differ[name] = ne
    _check(not differ, f"{what}: elements differ from the plain version {json.dumps(differ)} "
                       f"(max {worst:.3e} of scale, {worst_abs:.3e} absolute)")
    return differ, total, worst, worst_abs


def _k10_geometry(sp, carry):
    """The legs' geometry and stance as `runtime.step._walking_pre` hands
    them to K10's wrapper."""
    from quaternion_mpc_tpu_torch.runtime import step as rt

    return dict(rho_fix=rt._sp_rho_fix(sp, carry.plant.pos),
                default_rel=rt._sp_default_rel(sp, carry.plant.pos))


def _k10_walk_states(device):
    """States of the walking RTI fleet (B=4096, f32, 0.4 m/s) at
    K10_SNAPSHOTS on each of K10_TERRAINS, and of the estimated fleet
    (BasicKF, no noise) after K10_EST_TICKS, each run replayed from a CUDA
    graph with K10 counted once a tick: [(what, carry, sp, joy, est)]."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.control import quat_mpc
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.sim import terrain as terrain_mod
    from quaternion_mpc_tpu_torch.utils import config as cfg
    from quaternion_mpc_tpu_torch.utils.graphs import Graphed, clone_tree
    from quaternion_mpc_tpu_torch.utils.tree import tile

    f32, b = torch.float32, CLOSED_LOOP_B
    opts = _rti_opts()
    per_tick = opts.al_iterations * opts.ilqr_iterations
    wts = quat_mpc.weights_from_config(cfg.gazebo_go1_quat_mpc(), dtype=f32, device=device)
    states = []
    for kind in K10_TERRAINS:
        tp = None if kind == "flat" else terrain_mod.make_terrain(kind, dtype=f32, device=device)
        carry1, sp1 = rt.init_walking_scenario(wts, dtype=f32, terrain=tp, warm_start=True,
                                               horizon=HORIZON, device=device)
        joy1 = rt.neutral_joy(f32, device)._replace(
            velx=torch.full((), 0.4, dtype=f32, device=device))
        carry, sp, joy = (tile(t, b) for t in (carry1, sp1, joy1))
        graph = Graphed(rt.make_fleet_walking_step(HORIZON, opts, warm_start=True), chain=True)
        graph.captured(carry, sp, joy, None)
        done = 0
        for tick in K10_SNAPSHOTS:
            carry, _, _, _ = _drive(graph, carry, sp, joy, tick - done, (per_tick, 0),
                                    f"walking RTI fleet on {kind} B={b}, K10's states", k10=1)
            done = tick
            states.append((f"{kind} tick {tick}", clone_tree(carry), sp, joy, None))
        print(f"[K10] {kind}: {int(carry.alive.sum())} of {b} robots alive after {done} ticks")
    eopts = _est_opts()
    step, drive, _ = _est_step(device, eopts)
    carry, sp, joy = examples.estimated_batch(b, HORIZON, f32, device, velx=0.4)
    graph = Graphed(drive, chain=True)
    graph.captured(carry, sp, joy, None)
    carry, _, _, _ = _drive(graph, carry, sp, joy, K10_EST_TICKS,
                            (eopts.al_iterations * eopts.ilqr_iterations, 0),
                            f"estimated fleet (BasicKF) B={b}, K10's states", k10=1)
    carry = clone_tree(carry)
    states.append((f"estimated BasicKF tick {K10_EST_TICKS}", carry, sp, joy,
                   (carry.est.x[:, 0:3], carry.est.x[:, 3:6])))
    return states


def _k10_case(state, dtype, b):
    """One of `_k10_walk_states`' states cast to ``dtype`` and cut to its
    first ``b`` robots: (carry, sp, joy, gf, keywords of the pre)."""
    from quaternion_mpc_tpu_torch.utils.tree import tree_map

    _, carry, sp, joy, est = state
    cast = lambda t: t.to(dtype) if t.is_floating_point() else t
    cut = (lambda t: cast(t[:b])) if b < carry.plant.pos.shape[0] else cast
    c, s, j = (tree_map(cut, x) for x in (carry, sp, joy))
    kw = dict(horizon=HORIZON, gait_freq=2.2, per_knot_contacts=True,
              est_pos=None if est is None else cut(est[0]),
              est_vel=None if est is None else cut(est[1]))
    return c, s, j, torch.full((), 2.2, dtype=dtype, device=c.plant.pos.device), kw


def _k10_registers(kbuild, lib):
    """{dtype name: [registers, stack bytes, spill store bytes, spill load
    bytes]} of a K10 build, as ptxas reported."""
    return {("float32" if "IfE" in r["name"] else "float64"):
            [r["registers"], r["stack"], r["stores"], r["loads"]]
            for r in kbuild.ptxas_report(lib)}


def _k10_launcher(lib, pat, c, s, j, gf, kw):
    """fn() that launches ``lib``'s K10 once on these inputs into outputs
    made once and returns its two output buffers (float, int32); the tables
    are made once too, so that fn() is the launch alone."""
    from quaternion_mpc_tpu_torch.kernels import walking_pre as k10

    dtype = c.plant.pos.dtype
    table, lead, sizes = k10.check(c, s, j, pat, gf, **_k10_geometry(s, c), **kw)
    out, out_int, bufs = k10.new_outputs(lead, sizes, dtype, c.plant.pos.device)

    def fn():
        err = k10.launch(lib, table, sizes, out, out_int, dtype,
                         torch.cuda.current_stream().cuda_stream)
        _check(err == 0, f"K10 launch failed with CUDA error {err}")
        return bufs

    fn.table = table  # the copies live as long as fn
    return fn


def phase_walking_pre(device, states):
    """K10 (`kernels.walking_pre`, csrc/walking_pre.cu) against the plain
    version (`runtime.step._walking_pre_plain`) on the card, f32 and f64
    (the f32 states cast), at K10_CHECKED_B (B=4096 to 1), on states of 300-tick walks
    on flat, slope and stairs and of the estimated fleet (`_k10_walk_states`):
    every element of every output equal (`_k10_hold`); the elements that
    differ and the largest error printed.
    The fleet estimated step (kf_type 0, 1, 2) at B=64 launches K10 once a
    tick. K10 timed at B=4096 and B=1 by CUDA events around a replayed graph
    of 50 launches beside its bound (`kernels.walking_pre.work`), the plain
    version by events around eager calls; registers, stack and spills as
    ptxas reported.
    Returns a dict for the kernels line."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.kernels import build as kbuild
    from quaternion_mpc_tpu_torch.kernels import walking_pre as k10
    from quaternion_mpc_tpu_torch.runtime import step as rt

    t0 = time.perf_counter()
    pat = rt._pattern_on_device(None)(device)
    differ, worst = {}, {"float32": 0.0, "float64": 0.0}
    worst_abs = dict(worst)
    for state in states:
        what = state[0]
        for dtype in (torch.float32, torch.float64):
            for b in K10_CHECKED_B:
                c, s, j, gf, kw = _k10_case(state, dtype, b)
                got = k10.walking_pre(c, s, j, pat, gf, **_k10_geometry(s, c), **kw)
                want = rt._walking_pre_plain(c, s, j, pat, gf, **kw)
                tag = f"{what} {str(dtype)[6:]} B={b}"
                ne, total, rel, err = _k10_hold(got, want, tag)
                differ[tag] = [sum(ne.values()), total]
                worst[str(dtype)[6:]] = max(worst[str(dtype)[6:]], rel)
                worst_abs[str(dtype)[6:]] = max(worst_abs[str(dtype)[6:]], err)
                print(f"[K10] {tag}: {sum(ne.values())} of {total:,} elements differ from the "
                      f"plain version{' (' + json.dumps(ne) + ')' if ne else ''}, max "
                      f"{rel:.3e} of scale")

    # the fleet estimated step's estimators
    eopts = _est_opts()
    for kf in K10_KF_TYPES:
        step = rt.make_fleet_estimated_step(HORIZON, eopts, kf_type=kf)
        carry, sp, joy = examples.estimated_batch(K10_KF_B, HORIZON, torch.float32, device,
                                                  kf_type=kf)
        _drive(lambda c, s, j, ext: step(c, s, j, None, ext), carry, sp, joy, 2,
               (eopts.al_iterations * eopts.ilqr_iterations, 0),
               f"estimated fleet kf_type {kf} B={K10_KF_B}", k10=1)

    # timing at the fleet's shape and at one robot, on the flat walk's last state
    timing = {}
    regs = _k10_registers(kbuild, k10.build())
    for dtype, b in ((torch.float32, CLOSED_LOOP_B), (torch.float64, CLOSED_LOOP_B),
                     (torch.float32, 1), (torch.float64, 1)):
        c, s, j, gf, kw = _k10_case(states[len(K10_SNAPSHOTS) - 1], dtype, b)
        geo = _k10_geometry(s, c)
        ms = _graph_time(lambda: k10.walking_pre(c, s, j, pat, gf, **geo, **kw), reps=50) * 1e3
        host_ms = _enqueue_time(lambda: k10.walking_pre(c, s, j, pat, gf, **geo, **kw)) * 1e3
        plain_ms = _event_time(lambda: rt._walking_pre_plain(c, s, j, pat, gf, **kw),
                               reps=3) * 1e3
        work = k10.work(c, s, j, pat, gf, **geo, **kw)
        bound_ms, bound_by = _bound(work, dtype)
        tag = f"{str(dtype)[6:]} B={b}"
        timing[tag] = {"ms": ms, "host_enqueue_ms": host_ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "bytes": work["bytes"],
                       "registers_stack_spill": regs.get(str(dtype)[6:])}
        print(f"[timing] K10 {tag}: kernel {ms:.4f} ms (graph replay; host {host_ms:.4f} ms a "
              f"call), bound {bound_ms:.5f} ms by {bound_by} ({work['bytes'] / 2**20:.1f} MiB; "
              f"{100 * bound_ms / ms:.1f}% of it reached), plain {plain_ms:.3f} ms; registers, "
              f"stack, spill {regs.get(str(dtype)[6:])}")
    print(f"[K10] phase wall {time.perf_counter() - t0:.1f} s")
    return dict(differ=differ, worst=worst, worst_abs=worst_abs, timing=timing, registers=regs)


# --kernels-only: K10 at other block shapes (-DK10_WARPS) and, with
# --k10-baseline, another source of it with the same C interface (the
# parent's), each held bit for bit against the shipped build on every output
# at K10_CHECKED_B, f32 and f64, on `_k10_walk_states`' states, and timed in
# turns with it at K10_TIMED_B on the flat walk's last state.
K10_TIMED_B = (1, 256, CLOSED_LOOP_B)
K10_WARPS_SWEPT = (1, 2, 4)


def _k10_bits_differ(got, want) -> int:
    """Elements of two lists of buffers whose bits differ."""
    ints = {1: torch.uint8, 4: torch.int32, 8: torch.int64}
    return sum(int((g.view(ints[g.element_size()]) != w.view(ints[w.element_size()])).sum())
               for g, w in zip(got, want))


def _k10_tag(function):
    """A K10 kernel's dtype name from its mangled name (None: not a kernel)."""
    return ("float32" if "IfE" in function else "float64") if "kernel" in function else None


def _k10_sass(kbuild, lib, tag=_k10_tag):
    """cuobjdump's SASS of a build (the whole dump beside its library,
    `.sass`): {tag(kernel): {"instructions": n, opcode: count, "calls": [the
    CALL instructions' text]}} (K10's kernels by dtype unless told)."""
    cuobjdump = pathlib.Path(kbuild._nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    lib.with_suffix(".sass").write_text(dump)
    kernels, name = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = tag(m[1])
            if name:
                kernels[name] = {"instructions": 0, "calls": []}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)(.*?);", line)
        if name and m:
            op = m[1].split(".")[0]
            kernels[name]["instructions"] += 1
            kernels[name][op] = kernels[name].get(op, 0) + 1
            if op == "CALL":
                kernels[name]["calls"].append(f"{m[1]}{m[2]}".strip())
    return kernels


def phase_k10_designs(device, states, baseline=None):
    """--kernels-only: K10 built at each of K10_WARPS_SWEPT warps a block
    and, given ``baseline``, that source (as K10 is built: its FLAGS); what
    ptxas reported of each and the blocks of each resident on an SM; each
    held bit for bit against the shipped build (every element of both output
    buffers) at K10_CHECKED_B, f32 and f64, on `_k10_walk_states`' states;
    then timed in turns with it (shipped, the others, then back, twice) by
    events around a replayed graph of 50 launches at K10_TIMED_B, f32 and
    f64, beside the bound (its share of the median)."""
    from quaternion_mpc_tpu_torch.kernels import build as kbuild
    from quaternion_mpc_tpu_torch.kernels import walking_pre as k10
    from quaternion_mpc_tpu_torch.runtime import step as rt

    builds = {f"warps={w}": lambda w=w: kbuild.build(k10.SOURCE, k10.FLAGS + (f"-DK10_WARPS={w}",))
              for w in K10_WARPS_SWEPT}
    if baseline:
        builds["parent"] = lambda: kbuild.build(pathlib.Path(baseline).resolve(), k10.FLAGS)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        paths = {"shipped": k10.build(),
                 **dict(zip(builds, pool.map(lambda build: build(), builds.values())))}
    print(f"[K10] {len(builds)} more builds in {time.perf_counter() - t0:.1f} s")
    libs = {"shipped": k10._lib(), **{name: k10.bind(paths[name]) for name in builds},
            "shipped, loaded again": k10.bind(paths["shipped"])}
    paths["shipped, loaded again"] = paths["shipped"]
    for name, lib in libs.items():
        blocks = {}
        if hasattr(lib, "walking_pre_occupancy"):
            lib.walking_pre_occupancy.argtypes = [ctypes.c_int] * 3
            lib.walking_pre_occupancy.restype = ctypes.c_int
            blocks = {dt: lib.walking_pre_occupancy(f64, 100, 100)
                      for dt, f64 in (("float32", 0), ("float64", 1))}
        print(f"[K10] {name}: registers, stack, spill stores, spill loads "
              f"{_k10_registers(kbuild, paths[name])}; blocks an SM at windows of 100 "
              f"{blocks or 'not reported by this source'}")
    for name in ("shipped", *(["parent"] if baseline else [])):
        for dt, ops in sorted(_k10_sass(kbuild, paths[name]).items()):
            top = sorted(((n, op) for op, n in ops.items() if op not in ("instructions", "calls")),
                         reverse=True)
            print(f"[K10] SASS {name} {dt}: {ops['instructions']} instructions; "
                  + ", ".join(f"{op} {n}" for n, op in top[:20])
                  + f"; calls: {', '.join(sorted(set(ops['calls']))) or 'none'}")

    pat = rt._pattern_on_device(None)(device)
    others = [name for name in libs if name != "shipped"]
    differ = {name: [0, 0, 0, 0] for name in others}  # elements, of, launches off, launches
    for state in states:
        for dtype in (torch.float32, torch.float64):
            for b in K10_CHECKED_B:
                c, s, j, gf, kw = _k10_case(state, dtype, b)
                want = [t.clone() for t in _k10_launcher(libs["shipped"], pat, c, s, j, gf, kw)()]
                for name in others:
                    n = _k10_bits_differ(_k10_launcher(libs[name], pat, c, s, j, gf, kw)(), want)
                    d = differ[name]
                    d[0] += n
                    d[1] += sum(t.numel() for t in want)
                    d[2] += n > 0
                    d[3] += 1
                    if n:
                        print(f"[K10] bits: {name} {state[0]} {str(dtype)[6:]} B={b}: {n} "
                              f"elements differ")
    torch.cuda.synchronize()
    for name, (n, of, off, launches) in differ.items():
        print(f"[K10] bits: {name} against the shipped build over {launches} launches (every "
              f"output; K10_CHECKED_B, f32 and f64, the walks' and the estimated fleet's "
              f"states): {n} of {of:,} elements differ, in {off} launches")
    _check(all(d[0] == 0 for d in differ.values()),
           f"K10: a build's outputs differ from the shipped build's: {differ}")

    names = ["shipped", *others]
    for dtype in (torch.float32, torch.float64):
        for b in K10_TIMED_B:
            c, s, j, gf, kw = _k10_case(states[len(K10_SNAPSHOTS) - 1], dtype, b)
            fns = {name: _k10_launcher(libs[name], pat, c, s, j, gf, kw) for name in names}
            times = {name: [] for name in names}
            for name in (names + names[::-1]) * 2:
                times[name].append(_graph_time(fns[name], reps=50) * 1e3)
            bound_ms, bound_by = _bound(k10.work(c, s, j, pat, gf, **_k10_geometry(s, c), **kw),
                                        dtype)
            print(f"[K10] designs {str(dtype)[6:]} B={b}, in turns forward / backward, twice "
                  f"(bound {bound_ms:.5f} ms by {bound_by}): " + "; ".join(
                      f"{name} {' / '.join(f'{t:.4f}' for t in times[name])} ms "
                      f"({100 * bound_ms / statistics.median(times[name]):.2f}% of the bound)"
                      for name in names))


# ---------------------------------------------------------------------------
# K11, the SRB plant's tick and the safety mask (`kernels.srb_post`): held
# against the plain version on the card, timed, and counted on every SRB path.
# ---------------------------------------------------------------------------

K11_CHECKED_B = K10_CHECKED_B
K11_STAND_TICKS = 30  # the standing fleet's ticks before its states are taken


def _k11_inputs(tick):
    """The arguments (args, keywords) `runtime.step._srb_post` is called with
    in one eager ``tick()``, recorded."""
    from quaternion_mpc_tpu_torch.runtime import step as rt

    seen, post = [], rt._srb_post

    def spy(*args, **kw):
        seen.append((args, kw))
        return post(*args, **kw)

    rt._srb_post = spy
    try:
        tick()
    finally:
        rt._srb_post = post
    _check(len(seen) == 1, f"a tick called _srb_post {len(seen)} times")
    return seen[0]


def _k11_states(device, walk_states):
    """K11's inputs on the main paths' states: [(what, (args, keywords))]:
    one eager tick of the walking RTI fleet from each of `_k10_walk_states`'
    walking states, of the estimated fleet (BasicKF) from its state, and of
    the CLI's standing fleet after K11_STAND_TICKS replayed ticks, pushed
    (an ExtWrench of 20 N) and not."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.sim.plant import ExtWrench
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions
    from quaternion_mpc_tpu_torch.utils.graphs import Graphed, clone_tree
    from quaternion_mpc_tpu_torch.utils.tree import tile

    f32, b = torch.float32, CLOSED_LOOP_B
    walk = rt.make_fleet_walking_step(HORIZON, _rti_opts(), warm_start=True)
    est = rt.make_fleet_estimated_step(HORIZON, _est_opts(), kf_type=1)
    out = []
    for what, carry, sp, joy, e in walk_states:
        step = walk if e is None else (lambda c, s, j: est(c, s, j))
        out.append((what, _k11_inputs(lambda: step(carry, sp, joy))))
    sopts = SolverOptions(al_iterations=2, ilqr_iterations=5)
    stand = rt.make_fleet_standing_step(HORIZON, sopts)
    carry, sp, joy = examples.standing_fleet(b, f32, device)
    f = torch.tensor([0.0, 20.0, 0.0], dtype=f32, device=device)
    push = tile(ExtWrench(f, torch.linalg.cross(
        torch.tensor([0.0, 0.0, 0.1], dtype=f32, device=device), f)), b)
    graph = Graphed(stand, chain=True)
    graph.captured(carry, sp, joy, push)
    carry, _, _, _ = _drive(graph, carry, sp, joy, K11_STAND_TICKS,
                            (sopts.al_iterations * sopts.ilqr_iterations, 0),
                            f"standing fleet B={b} pushed, K11's states", ext=push)
    carry = clone_tree(carry)  # out of the graph's buffers
    for what, ext in (("standing", None), ("standing pushed", push)):
        out.append((f"{what} tick {K11_STAND_TICKS}",
                    _k11_inputs(lambda: stand(carry, sp, joy, ext))))
    return out


def _k11_case(rec, dtype, b):
    """Recorded K11 inputs cast to ``dtype`` and cut to the first ``b``
    scenarios (a leaf every scenario shares stays as it is)."""
    from quaternion_mpc_tpu_torch.utils.tree import tree_map

    args, kw = rec
    B = args[0].pos.shape[0]

    def cut(t):
        if not isinstance(t, torch.Tensor):
            return t
        if b < B and t.dim() > 0 and t.shape[0] == B:
            t = t[:b]
        return t.to(dtype) if t.is_floating_point() else t

    return (tuple(tree_map(cut, a) for a in args),
            {k: tree_map(cut, v) for k, v in kw.items()})


def _k11_named(out):
    """An `SrbPost` as (name, tensor) pairs, the absent fields left out."""
    named = []
    for field, v in zip(out._fields, out):
        if isinstance(v, tuple):
            named += [(f"{field}.{f}", x) for f, x in zip(v._fields, v)]
        elif v is not None:
            named.append((field, v))
    return named


def _k11_differ(got, want, what):
    """K11's outputs against the plain version's, element by element (NaN
    where the plain version has NaN): ({output: elements that differ} where
    any do, elements in all, the largest error relative to the output's
    scale, the largest absolute error)."""
    differ, total, worst, worst_abs = {}, 0, 0.0, 0.0
    for (name, g), (_, w) in zip(_k11_named(got), _k11_named(want), strict=True):
        _check(g.shape == w.shape and g.dtype == w.dtype, f"{what}: {name} shape or dtype")
        total += w.numel()
        if not w.is_floating_point():
            ne = int((g != w).sum())
        else:
            both_nan = torch.isnan(g) & torch.isnan(w)
            ne = int(((g != w) & ~both_nan).sum())
            d = torch.nan_to_num(torch.where(both_nan, 0.0, (g.double() - w.double()).abs()),
                                 nan=math.inf)
            scale = torch.nan_to_num(w.double(), nan=0.0).abs().max().clamp(min=1e-300)
            if d.numel():
                worst = max(worst, float(d.max() / scale))
                worst_abs = max(worst_abs, float(d.max()))
        if ne:
            differ[name] = ne
    return differ, total, worst, worst_abs


def _k11_launcher(lib, args, kw):
    """fn() that launches ``lib``'s K11 once on these inputs into outputs
    made once and returns its two output buffers (the state's dtype, bool);
    the tables are made once too, so that fn() is the launch alone."""
    from quaternion_mpc_tpu_torch.kernels import srb_post as k11

    dtype = args[0].pos.dtype
    table, lead, sizes = k11.check(*args, **kw)
    out, alive, bufs = k11.new_outputs(lead, sizes, dtype, args[0].pos.device)

    def fn():
        err = k11.launch(lib, table, sizes, out, alive, dtype,
                         torch.cuda.current_stream().cuda_stream)
        _check(err == 0, f"K11 launch failed with CUDA error {err}")
        return bufs

    fn.table = table  # the copies live as long as fn
    return fn


def _k11_tag(function):
    """"<dtype> <mode>[ push]" of one of K11's eight kernels from its mangled
    name (its template arguments), or None."""
    m = re.search(r"srb_post_kernelI([fd])Lb([01])ELb([01])E", function)
    return None if m is None else (
        f"{'float32' if m[1] == 'f' else 'float64'} "
        f"{'walking' if m[2] == '1' else 'standing'}{' push' if m[3] == '1' else ''}")


def _k11_registers(kbuild, lib):
    """{"<dtype> <mode>[ push]": [registers, stack bytes, spill store bytes,
    spill load bytes]} of a K11 build's eight kernels, as ptxas reported."""
    return {_k11_tag(r["name"]): [r["registers"], r["stack"], r["stores"], r["loads"]]
            for r in kbuild.ptxas_report(lib) if _k11_tag(r["name"])}


def phase_srb_post(device, walk_states, recs=None):
    """K11 (`kernels.srb_post`, csrc/srb_post.cu) against the plain version
    (`runtime.step._srb_post_plain`) on the card, f32 and f64 (the f32
    inputs cast), at K11_CHECKED_B (B=4096 to 1), on the inputs one eager
    tick hands it from the states of 300-tick walks on flat, slope and
    stairs, of the estimated fleet and of the standing fleet, pushed and not
    (`_k11_states`): every element of every output equal; the elements that
    differ printed for every case before the check. K11 timed at B=4096 and
    B=1 (the flat walk's last state; the pushed standing fleet's at B=4096)
    by CUDA events around a replayed graph of 50 launches beside its bound
    (`kernels.srb_post.work`), the plain version by events around eager
    calls; registers, stack and spills as ptxas reported. ``recs``: the
    states `_k11_states` recorded, where already made. Returns a dict for the
    kernels line."""
    from quaternion_mpc_tpu_torch.kernels import build as kbuild
    from quaternion_mpc_tpu_torch.kernels import srb_post as k11
    from quaternion_mpc_tpu_torch.runtime import step as rt

    t0 = time.perf_counter()
    recs = recs or _k11_states(device, walk_states)
    differ, worst = {}, {"float32": 0.0, "float64": 0.0}
    worst_abs = dict(worst)
    failed = {}
    for what, rec in recs:
        for dtype in (torch.float32, torch.float64):
            for b in K11_CHECKED_B:
                args, kw = _k11_case(rec, dtype, b)
                got = k11.srb_post(*args, **kw)
                want = rt._srb_post_plain(*args, **kw)
                tag = f"{what} {str(dtype)[6:]} B={b}"
                ne, total, rel, err = _k11_differ(got, want, tag)
                differ[tag] = [sum(ne.values()), total]
                worst[str(dtype)[6:]] = max(worst[str(dtype)[6:]], rel)
                worst_abs[str(dtype)[6:]] = max(worst_abs[str(dtype)[6:]], err)
                if ne:
                    failed[tag] = ne
                print(f"[K11] {tag}: {sum(ne.values())} of {total:,} elements differ from the "
                      f"plain version{' (' + json.dumps(ne) + ')' if ne else ''}, max "
                      f"{rel:.3e} of scale, {err:.3e} absolute")
    _check(not failed, f"K11: elements differ from the plain version: {json.dumps(failed)}")

    timing = {}
    regs = _k11_registers(kbuild, k11.build())
    flat = next(rec for what, rec in recs if what.startswith("flat tick 300"))
    pushed = next(rec for what, rec in recs if what.startswith("standing pushed"))
    for what, rec, dtype, b in (("walking", flat, torch.float32, CLOSED_LOOP_B),
                                ("walking", flat, torch.float64, CLOSED_LOOP_B),
                                ("walking", flat, torch.float32, 1),
                                ("walking", flat, torch.float64, 1),
                                ("standing pushed", pushed, torch.float32, CLOSED_LOOP_B)):
        args, kw = _k11_case(rec, dtype, b)
        ms = _graph_time(lambda: k11.srb_post(*args, **kw), reps=50) * 1e3
        host_ms = _enqueue_time(lambda: k11.srb_post(*args, **kw)) * 1e3
        plain_ms = _event_time(lambda: rt._srb_post_plain(*args, **kw), reps=3) * 1e3
        work = k11.work(*args, **kw)
        bound_ms, bound_by = _bound(work, dtype)
        tag = f"{what} {str(dtype)[6:]} B={b}"
        timing[tag] = {"ms": ms, "host_enqueue_ms": host_ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "bytes": work["bytes"],
                       "flops": work["flops"]}
        print(f"[timing] K11 {tag}: kernel {ms:.4f} ms (graph replay; host {host_ms:.4f} ms a "
              f"call), bound {bound_ms:.5f} ms by {bound_by} ({work['bytes'] / 2**20:.2f} MiB, "
              f"{work['flops']:,} flops; {100 * bound_ms / ms:.2f}% of it reached), plain "
              f"{plain_ms:.3f} ms")
    print(f"[K11] registers, stack, spill stores, spill loads: {json.dumps(regs)}")
    print(f"[K11] phase wall {time.perf_counter() - t0:.1f} s")
    return dict(differ=differ, worst=worst, worst_abs=worst_abs, timing=timing, registers=regs)



# --kernels-only: K11 at other block shapes (-DK11_WARPS) and, with
# --k11-baseline, another source of it with the same C interface (the
# parent's, beside its own csrc/closed_loop.cuh), held bit for bit against
# the shipped build and timed in turns with it at K11_TIMED_B.
K11_TIMED_B = (1, 256, CLOSED_LOOP_B)
K11_WARPS_SWEPT = (1, 2, 4)


def phase_k11_designs(device, recs, baseline=None):
    """--kernels-only: K11 built at each of K11_WARPS_SWEPT warps a block
    and, given ``baseline``, that source (as K11 is built: its FLAGS); what
    ptxas reported of each and the blocks of each resident on an SM; each
    held bit for bit against the shipped build (every element of both output
    buffers) at K11_CHECKED_B, f32 and f64, on `_k11_states`' states (``recs``:
    the walks on flat, slope and stairs, the estimated fleet, the standing
    fleet pushed and not); then timed in turns with it (shipped, the others,
    then back, twice) by events around a replayed graph of 50 launches at
    K11_TIMED_B, f32 and f64, walking (the flat walk's last state) and
    standing (pushed), beside the bound (its share of the median)."""
    from quaternion_mpc_tpu_torch.kernels import build as kbuild
    from quaternion_mpc_tpu_torch.kernels import srb_post as k11

    builds = {f"warps={w}": lambda w=w: kbuild.build(k11.SOURCE, k11.FLAGS + (f"-DK11_WARPS={w}",))
              for w in K11_WARPS_SWEPT}
    for source in (baseline or "").split(","):
        if source:  # named by its directory
            path = pathlib.Path(source).resolve()
            builds[path.parent.name] = lambda path=path: kbuild.build(path, k11.FLAGS)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        paths = {"shipped": k11.build(),
                 **dict(zip(builds, pool.map(lambda build: build(), builds.values())))}
    print(f"[K11] {len(builds)} more builds in {time.perf_counter() - t0:.1f} s")
    libs = {"shipped": k11._lib(), **{name: k11.bind(paths[name]) for name in builds}}
    for name, lib in libs.items():
        blocks = "not reported by this source"
        if hasattr(lib, "srb_post_occupancy"):
            lib.srb_post_occupancy.argtypes = [ctypes.c_int] * 3
            lib.srb_post_occupancy.restype = ctypes.c_int
            blocks = {f"{dt} {mode}{' push' if ext else ''}": lib.srb_post_occupancy(f64, walk, ext)
                      for dt, f64 in (("float32", 0), ("float64", 1))
                      for mode, walk in (("walking", 1), ("standing", 0)) for ext in (0, 1)}
        print(f"[K11] {name}: registers, stack, spill stores, spill loads "
              f"{json.dumps(_k11_registers(kbuild, paths[name]))}; blocks an SM {blocks}")
        for tag, ops in sorted(_k10_sass(kbuild, paths[name], _k11_tag).items()):
            top = sorted(((n, op) for op, n in ops.items() if op not in ("instructions", "calls")),
                         reverse=True)
            print(f"[K11] SASS {name} {tag}: {ops['instructions']} instructions; "
                  + ", ".join(f"{op} {n}" for n, op in top[:16]))

    others = [name for name in libs if name != "shipped"]
    differ = {name: [0, 0, 0, 0] for name in others}  # elements, of, launches off, launches
    for what, rec in recs:
        for dtype in (torch.float32, torch.float64):
            for b in K11_CHECKED_B:
                args, kw = _k11_case(rec, dtype, b)
                want = [t.clone() for t in _k11_launcher(libs["shipped"], args, kw)()]
                for name in others:
                    n = _k10_bits_differ(_k11_launcher(libs[name], args, kw)(), want)
                    d = differ[name]
                    d[0] += n
                    d[1] += sum(t.numel() for t in want)
                    d[2] += n > 0
                    d[3] += 1
                    if n:
                        print(f"[K11] bits: {name} {what} {str(dtype)[6:]} B={b}: {n} elements "
                              f"differ")
    torch.cuda.synchronize()
    for name, (n, of, off, launches) in differ.items():
        print(f"[K11] bits: {name} against the shipped build over {launches} launches (every "
              f"output; K11_CHECKED_B, f32 and f64, the walks', the estimated and the standing "
              f"fleets' states): {n} of {of:,} elements differ, in {off} launches")
    _check(all(d[0] == 0 for d in differ.values()),
           f"K11: a build's outputs differ from the shipped build's: {differ}")

    named = dict(recs)
    timed = {"walking": named[f"flat tick {K10_SNAPSHOTS[-1]}"],
             "standing pushed": named[f"standing pushed tick {K11_STAND_TICKS}"]}
    names = ["shipped", *others]
    for mode, rec in timed.items():
        for dtype in (torch.float32, torch.float64):
            for b in K11_TIMED_B:
                args, kw = _k11_case(rec, dtype, b)
                fns = {name: _k11_launcher(libs[name], args, kw) for name in names}
                times = {name: [] for name in names}
                for name in (names + names[::-1]) * 2:
                    times[name].append(_graph_time(fns[name], reps=50) * 1e3)
                bound_ms, bound_by = _bound(k11.work(*args, **kw), dtype)
                print(f"[K11] designs {mode} {str(dtype)[6:]} B={b}, in turns forward / "
                      f"backward, twice (bound {bound_ms:.5f} ms by {bound_by}): " + "; ".join(
                          f"{name} {' / '.join(f'{t:.4f}' for t in times[name])} ms "
                          f"({100 * bound_ms / statistics.median(times[name]):.2f}% of the bound)"
                          for name in names))


# The estimated fleet (`make_fleet_estimated_step`): the bench's noise levels
# (bench.py:379-383) for the timed tick, tests/test_estimated_walking.py's
# for the 200-tick quality run (:63-67).
EST_BENCH_STDS = dict(noise_acc=0.2, noise_gyro=0.02, noise_foot_vel=0.02, noise_foot_pos=0.003)
EST_TEST_STDS = dict(noise_acc=0.3, noise_gyro=0.03, noise_foot_vel=0.03, noise_foot_pos=0.004)
EST_TICKS, EST_F64_B = 200, 256
EKF_TICKS = 100
# test_estimated_walking.py:77-82: every robot alive, min x > 0.25 m after 2 s
# at 0.3 m/s, final |p_est − p_true| < 0.06 m; :113-124: EKF with mocap on,
# < 0.01 m after 100 ticks at 0.4 m/s.
EST_MIN_X, EST_MAX_ERR, EKF_MAX_ERR = 0.25, 0.06, 0.01
# f64 card vs CPU over 10 noisy ticks at B=64, the same noise tensors on both
EST_F64_TOL = 1e-7


def _est_opts():
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    return SolverOptions(al_iterations=2, ilqr_iterations=4)  # test_estimated_walking.py:15


def _est_step(device, opts, kf_type=1, seed=0, **stds):
    """(the estimated step drawing its noise from a CUDA generator seeded
    with ``seed``, the same step in `_drive`'s (carry, sp, joy, ext) form,
    the generator or None)."""
    from quaternion_mpc_tpu_torch.runtime import step as rt

    gen = torch.Generator(device=device).manual_seed(seed) if stds else None
    step = rt.make_fleet_estimated_step(HORIZON, opts, kf_type=kf_type, generator=gen, **stds)
    return step, lambda carry, sp, joy, ext=None: step(carry, sp, joy, None, ext), gen


def _est_err(carry):
    return torch.linalg.norm(carry.est.x[:, 0:3] - carry.plant.pos, dim=-1)


def _est_quality(device, dtype, batch):
    """test_estimated_walking.py:42-82 on the card: EST_TICKS noisy ticks of
    the BasicKF fleet at 0.3 m/s, 2 x 4, initial velocities 0.05·N(0, 1)."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.utils.graphs import Graphed

    opts = _est_opts()
    per_tick = opts.al_iterations * opts.ilqr_iterations
    _, drive, gen = _est_step(device, opts, seed=7, **EST_TEST_STDS)
    carry, sp, joy = examples.estimated_batch(batch, HORIZON, dtype, device)
    vel = 0.05 * np.random.default_rng(5).standard_normal((batch, 3))
    carry = carry._replace(plant=carry.plant._replace(
        vel=torch.from_numpy(vel).to(device=device, dtype=dtype)))
    what = f"estimated fleet {str(dtype)[6:]} B={batch}, replayed from a CUDA graph"
    # the tick replayed as the CLI's loops replay theirs, its generator
    # registered with the graph (the capture leaves it as it found it)
    graph = Graphed(drive, chain=True, generators=(gen,))
    graph.captured(carry, sp, joy, None)
    t0 = time.perf_counter()
    carry, _, _, _ = _drive(graph, carry, sp, joy, EST_TICKS, (per_tick, 0), what, k10=1)
    ms = (time.perf_counter() - t0) / EST_TICKS * 1e3
    x, err = carry.plant.pos[:, 0], _est_err(carry)
    _check(bool(carry.alive.all()), f"{what}: {int((~carry.alive).sum())} robots down")
    _check(_all_finite(carry.plant) and _all_finite(carry.est), f"{what}: non-finite state")
    _check(x.min().item() > EST_MIN_X, f"{what}: min x {x.min().item():.3f} m <= {EST_MIN_X}")
    _check(err.max().item() < EST_MAX_ERR,
           f"{what}: max |p_est - p_true| {err.max().item():.4f} m >= {EST_MAX_ERR}")
    print(f"[estimated] {what}, kf_type 1, 2x4, {EST_TICKS} noisy ticks at 0.3 m/s: K1 launches "
          f"{per_tick}/tick, K4 0, all alive; x {x.min().item():.4f}-{x.max().item():.4f} m "
          f"(> {EST_MIN_X}); |p_est - p_true| mean {err.mean().item():.4f}, max "
          f"{err.max().item():.4f} m (< {EST_MAX_ERR}); {ms:.2f} ms/tick over the run")


def _ekf_quality(device):
    """test_estimated_walking.py:101-124's fused leg on the card: the EKF
    fleet with mocap on, f64, 0.4 m/s. Returns (step, carry, sp, joy) at a
    tick where a mocap sample is due and fused."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.utils.graphs import Graphed

    b, dtype, opts = EST_F64_B, torch.float64, _est_opts()
    per_tick = opts.al_iterations * opts.ilqr_iterations
    step, _, _ = _est_step(device, opts, kf_type=2)
    carry, sp, joy = examples.estimated_batch(b, HORIZON, dtype, device, kf_type=2, velx=0.4)
    on = torch.ones((), dtype=torch.bool, device=device)
    graph = Graphed(lambda c, s, j, ext: step(c, s, j, on, ext), chain=True)
    graph.captured(carry, sp, joy, None)
    carry, _, _, _ = _drive(graph, carry, sp, joy, EKF_TICKS, (per_tick, 0),
                            "EKF fleet, replayed from a CUDA graph", k10=1)
    err = _est_err(carry)
    _check(bool(carry.alive.all()), f"EKF fleet: {int((~carry.alive).sum())} robots down")
    _check(err.max().item() < EKF_MAX_ERR,
           f"EKF fleet: max |p_est - p_true| {err.max().item():.5f} m >= {EKF_MAX_ERR}")
    _check(bool((carry.tick == EKF_TICKS).all()) and bool((carry.mocap_count == 20).all()),
           f"EKF fleet: tick {carry.tick[0].item()}, mocap samples {carry.mocap_count[0].item()}")
    print(f"[estimated] EKF fleet f64 B={b}, kf_type 2, mocap on, 2x4, {EKF_TICKS} ticks at 0.4 "
          f"m/s: all alive, x {carry.plant.pos[:, 0].min().item():.4f} m, {EKF_TICKS // 5} mocap "
          f"samples, |p_est - p_true| max {err.max().item():.5f} m (< {EKF_MAX_ERR})")
    return step, carry, sp, joy


def _worker_walking(dtype):
    def run(device):
        from quaternion_mpc_tpu_torch.runtime import step as rt

        _walking_quality(rt.make_fleet_walking_step(HORIZON, _rti_opts(), warm_start=True),
                         dtype, device)
    return run


# the robots of the moved f32 walking fleet upright and within
# test_walking.py's bounds before K9 took the open-loop rollout and the
# pricing (PERF.md: NVIDIA H100 80GB HBM3 at 700 W)
WALK_MOVED_BEFORE_K9 = (2069, 1122)


def _worker_walking_moved(device):
    """Worker, a record and not a check: the f32 walking fleet of the quality
    run with each robot's start moved by 1e-6 m of seeded noise; prints how
    many robots stay upright and meet test_walking.py's bounds. The quality
    run's robots are identical, one trajectory in f32; this shows how far its
    fate is one draw of the rounding."""
    from quaternion_mpc_tpu_torch.runtime import step as rt

    what = "walking RTI fleet float32, starts moved by 1e-6 m"
    carry, vel_err, h_err, _, _ = _walk_300(
        rt.make_fleet_walking_step(HORIZON, _rti_opts(), warm_start=True), torch.float32, device,
        what, moved=1e-6)
    met = (carry.alive & (carry.plant.pos[:, 0] > 0.9) & (vel_err < 0.05) & (h_err < 0.01))
    print(f"[closed-loop] {what} (a record, not held): {int(carry.alive.sum())} of "
          f"{CLOSED_LOOP_B} upright, {int(met.sum())} within test_walking.py's bounds "
          f"(f64 and the unmoved f32 fleet are held to them in every robot); before K9 "
          f"{WALK_MOVED_BEFORE_K9[0]} upright, {WALK_MOVED_BEFORE_K9[1]} within them")


def _worker_ekf(device):
    step, carry, sp, joy = _ekf_quality(device)
    _no_sync_tick(lambda: step(carry, sp, joy, True),
                  f"B={EST_F64_B} EKF (mocap sample due and fused)", "estimated")


# The long closed-loop runs are host-bound (a tick is ~9-23k eager launches at
# 9-18 us each and leaves the card idle ~80% of the time), so the ones that
# are only held to bounds, not timed, run side by side, each in a process of
# its own (`chip_smoke.py --worker NAME`), while the main process drives the
# f32 estimated fleet and then phase 12's untimed checks. A worker drives its
# step through the same `_drive` (launch counts checked every tick) and exits
# non-zero on a miss. Every timing and profile is taken in the main process
# while no worker runs; so is every launch count of the kernels line but
# phase 12's counted solves (a count belongs to its process: other processes
# cannot move it).
WORKERS = {  # the longest first
    "estimated-f64": lambda device: _est_quality(device, torch.float64, EST_F64_B),
    "walking-f32": _worker_walking(torch.float32),
    "walking-f64": _worker_walking(torch.float64),
    "walking-f32-moved": _worker_walking_moved,
    "ekf": _worker_ekf,
    "estimated-card-vs-cpu": lambda device: _est_card_vs_cpu(device),
    "walking-card-vs-cpu": lambda device: phase_walking_f64(device),
    # phase 12's quality runs
    "falling-cat-loop": lambda device: _worker_cat_loop(device),
    "single-problem-quality": lambda device: _worker_single_quality(device),
}


def _start_workers(names):
    return {name: subprocess.Popen([sys.executable, __file__, "--worker", name],
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name in names}


def _join_workers(procs):
    """Waits for every worker, prints what each printed, and fails if one
    failed; no worker outlives the call."""
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            sys.stdout.write(out)
            _check(proc.returncode == 0, f"worker {name} exited {proc.returncode}: {err[-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _est_card_vs_cpu(device):
    """10 noisy f64 ticks of the BasicKF fleet at B=64 (a velocity spread,
    robot 0 pushed) on the card against the CPU, both handed the same noise
    tensors."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.sim.plant import ExtWrench

    b, dtype = 64, torch.float64
    torch.set_num_threads(2)  # the CPU half runs beside the other workers
    step = rt.make_fleet_estimated_step(HORIZON, _est_opts(), kf_type=1, **EST_TEST_STDS)
    velx = 0.4 * np.random.default_rng(0).random(b)
    force = np.zeros((b, 3))
    force[0, 0] = 20.0
    gen = torch.Generator(device="cpu").manual_seed(3)
    draws = [rt.SensorNoise(*(torch.randn((b,) + s, generator=gen, dtype=dtype)
                              for s in ((3,), (3,), (4, 3), (4, 3)))) for _ in range(10)]
    runs = []  # the card's ticks, then the CPU's
    for dev in (device, torch.device("cpu")):
        carry, sp, joy = examples.estimated_batch(b, HORIZON, dtype, dev)
        joy = joy._replace(velx=torch.from_numpy(velx).to(dev))
        ext = ExtWrench(force_world=torch.from_numpy(force).to(dev),
                        torque_body=torch.zeros((b, 3), dtype=dtype, device=dev))
        ticks = []
        for noise in draws:
            noise = rt.SensorNoise(*(n.to(dev) for n in noise))
            carry, _ = step(carry, sp, joy, None, ext, noise=noise)
            ticks.append(carry)
        runs.append(ticks)
    pos_err = est_err = 0.0
    for cu, cp in zip(*runs):
        pos_err = max(pos_err, (cu.plant.pos.cpu() - cp.plant.pos).abs().max().item())
        est_err = max(est_err, (cu.est.x.cpu() - cp.est.x).abs().max().item())
        _check(torch.equal(cu.alive.cpu(), cp.alive), "f64 estimated: alive differs card vs CPU")
    _check(pos_err <= EST_F64_TOL and est_err <= EST_F64_TOL,
           f"f64 estimated card vs CPU: plant pos {pos_err:.3e}, est.x {est_err:.3e} "
           f"(tol {EST_F64_TOL})")
    print(f"[estimated] f64 BasicKF fleet B={b}, 10 noisy ticks (same noise tensors), card vs "
          f"CPU: max|plant pos err| {pos_err:.3e} m, max|est.x err| {est_err:.3e} (tol "
          f"{EST_F64_TOL}), alive equal ({int(runs[0][-1].alive.sum())}/{b})")


def phase_estimated_fleet(device, smi, beside_workers=None):
    """The bench's estimated fleet (bench.py:360-387): B=4096 robots with the
    BasicKF in the loop under sensor noise, N=10, 2 x 5, 8 alphas, f32; K1
    solves every tick. Timed as the bench times it (the same carry each
    call); exactly 10 K1 launches a tick (and at B=1 10 of K4's
    `assoc_backward`, no K1); no host synchronisation in a tick with the KF
    or with the EKF and a mocap fusion; the quality bounds of
    test_estimated_walking.py in f64 (B=256) and f32 (B=4096); the EKF with
    mocap; f64 card against CPU; a profile split by range.
    ``beside_workers()`` runs in this process after the f32 quality run while
    the workers finish: checks that compare values and count launches, no
    timings. Returns a dict:
    p50 / min / max seconds of the timed tick, (K1, K4) launches a tick at
    B=4096 and at B=1, the K1 launches of the counted B=4096 tick and the K4
    launches of the counted B=1 ticks, and the profile."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    t_phase = time.perf_counter()
    b = CLOSED_LOOP_B
    opts = SolverOptions(al_iterations=2, ilqr_iterations=5, max_linesearch=8)  # bench.py:305
    per_tick = opts.al_iterations * opts.ilqr_iterations
    step, drive, _ = _est_step(device, opts, seed=0, **EST_BENCH_STDS)
    carry, sp, joy = examples.estimated_batch(b, HORIZON, torch.float32, device)
    for _ in range(2):
        step(carry, sp, joy)
    torch.cuda.synchronize()
    # the counted tick: counts set to 0 just before, read just after
    out, _, _, per = _drive(drive, carry, sp, joy, 1, (per_tick, 0), "estimated B=4096",
                            path="estimated_2x5_B4096_B1", k10=1)
    _check(bool(out.alive.all()) and _all_finite(out.plant) and _all_finite(out.est),
           "estimated B=4096: a robot down or a non-finite state after one tick")
    _check(tuple(out.est.x.shape) == (b, 18) and tuple(out.est.P.shape) == (b, 18, 18)
           and out.tick.dtype == torch.int32 and bool((out.tick == 1).all()), "estimated: shapes")
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        step(carry, sp, joy)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    print(f"[estimated] fleet f32 B={b}, kf_type 1, 2x5, 8 alphas, noise {tuple(EST_BENCH_STDS.values())}: "
          f"K1 launches {per_tick}/tick, K4 0; p50 {p50 * 1e3:.2f} ms/tick (min "
          f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}; 10 ticks from the same carry "
          f"after 2 warm-ups), {b / p50:,.0f} solves/s; {smi}")
    _no_sync_tick(lambda: step(carry, sp, joy), f"B={b} BasicKF", "estimated")

    one = examples.estimated_batch(1, HORIZON, torch.float32, device)
    one_ticks = 2
    c1, _, _, per_one = _drive(drive, *one, one_ticks, (0, per_tick), "estimated B=1",
                               path="estimated_2x5_B4096_B1", k10=1)
    _check(bool(c1.alive.all()), "estimated B=1: robot down")
    print(f"[estimated] B=1 (auto): K4 assoc_backward launches {per_tick}/tick, K1 0")

    t_q = time.perf_counter()
    workers = _start_workers(WORKERS)
    try:
        _est_quality(device, torch.float32, b)
        if beside_workers is not None:
            beside_workers()
    finally:
        _join_workers(workers)
    t_c = time.perf_counter()
    try:
        prof = _profile_tick(lambda: step(carry, sp, joy), p50, f"B={b} estimated tick (2x5)",
                             (rt.PRE, rt.SOLVE, rt.POST, rt.EST))
    except RuntimeError as e:  # a record, not a check: the tracer may be unavailable
        print(f"[profile] estimated tick not measured: {e}")
        prof = None
    if prof and "est" in prof["split"]:
        est, ops = prof["split"]["est"], prof["device_ops"]
        share = (f", {100 * est['device_ms'] / prof['device_busy_ms']:.1f}% of its device time"
                 if "device_ms" in est else "")
        print(f"[profile] the estimator holds {est['launches']} of the tick's launches "
              f"({100 * est['launches'] / ops:.1f}% of {ops} device ops){share}")
    now = time.perf_counter()
    print(f"[estimated] phase wall {now - t_phase:.1f} s (quality runs, {len(WORKERS)} of them in "
          f"worker processes beside the f32 fleet, {t_c - t_q:.1f} s; profile "
          f"{now - t_c:.1f} s)")
    return dict(p50=p50, min=min(times), max=max(times), per_tick=per, per_tick_one=per_one,
                k1_launches=round(per[0]), k4_launches=round(per_one[1] * one_ticks), profile=prof)



# ---------------------------------------------------------------------------
# Phase 12: the single-problem path (`solver.al_ilqr.make_solver`)
# ---------------------------------------------------------------------------

# K1 at ne, nu <= 12 is held to the plain sweep at the problem's own size on
# the first backward pass of these problems: (family, ne, nu).
SINGLE_FAMILIES = (("humanoid", 12, 6), ("falling_cat", 6, 3), ("pendulum", 2, 1),
                   ("double_integrator", 4, 2))
SINGLE_CHECKED_N = (20, 40)
SINGLE_CHECKED_B = (1, 7, 4096)
CAT_FLEET_B = 4096
CAT_LOOP_TICKS = 51  # the reference's bound is on tick 50's error (test_branch_configs.py:217)
BICYCLE_TICKS = 4
# K1 with the cross term lux: the mixed-row bicycle fleet's (N, B)
CROSS_CHECKED_N = (15, 30)
CROSS_CHECKED_B = (1, 7, 4096)


def _family_problem(family, horizon, dtype, device):
    """(ModelSpec, TrajOptProblem) of a problem family at ``horizon`` knots."""
    from quaternion_mpc_tpu_torch import examples, scenarios

    if family in scenarios.SCENARIOS:
        return scenarios.SCENARIOS[family](N=horizon, dtype=dtype, device=device)[:2]
    return examples.classic_problem(family, horizon, dtype, device)


def _family_first_pass(family, horizon, batch, dtype, device):
    """K1's inputs, at the family's own (ne, nu), on the first backward pass of
    a fleet of ``batch`` of the problem from perturbed starts and inputs."""
    from quaternion_mpc_tpu_torch.solver import al_ilqr

    spec, prob = _family_problem(family, horizon, dtype, device)
    gen = torch.Generator(device=device).manual_seed(horizon + batch)
    noise = lambda like, std: std * torch.randn((batch,) + like.shape, generator=gen, dtype=dtype,
                                                device=device)
    fleet_prob = al_ilqr.broadcast_problem(prob, batch)._replace(
        x0=prob.x0 + noise(prob.x0, 0.05), us_init=prob.us_init + noise(prob.us_init, 0.3))
    return _first_pass(al_ilqr.lift_problem(fleet_prob), al_ilqr.fleet_spec(spec))


def _random_first_pass(ne, nu, horizon, batch, dtype, device):
    """Well-posed K1 inputs at (ne, nu) from a seeded generator on the card:
    contracting As, SPD lxx, luu and lxxN, reg 1e-6."""
    gen = torch.Generator(device=device).manual_seed(ne * 100 + nu + batch)
    r = lambda *shape: torch.randn(shape, generator=gen, dtype=torch.float64, device=device)
    eye = lambda n: torch.eye(n, dtype=torch.float64, device=device)[..., None]
    spd = lambda n, *lead: (lambda m: torch.einsum("...ikb,...jkb->...ijb", m, m)
                            + 0.5 * eye(n))(r(*lead, n, n, batch))
    out = (0.3 * r(horizon, ne, ne, batch) + eye(ne), 0.2 * r(horizon, ne, nu, batch),
           r(horizon, ne, batch), spd(ne, horizon), r(horizon, nu, batch), spd(nu, horizon),
           r(ne, batch), spd(ne), torch.full((batch,), 1e-6, dtype=torch.float64, device=device))
    return [t.to(dtype).contiguous() for t in out]


def _embedded(rs, args, luxs=None):
    """The parent's launch of a problem below 12 x 12: `embed` into 12 x 12,
    the 12 x 12 instantiation, the live block of its outputs."""
    ne, nu = args[0].shape[1], args[1].shape[2]
    big = rs.embed(*args, luxs=luxs)
    out = rs.riccati_sweep(*big[:9], luxs=None if luxs is None else big[9])
    return (out[0][:, :nu, :ne], out[1][:, :nu], *out[2:])


def _differ(got, other):
    """(elements of the five outputs that differ, elements in all)."""
    return (sum(int((g != o).sum()) for g, o in zip(got, other)),
            sum(g.numel() for g in got))


def phase_small_kernel_vs_plain(device):
    """K1 through its wrapper at SINGLE_FAMILIES x SINGLE_CHECKED_N x
    SINGLE_CHECKED_B, each family at its own instantiation, and at a 5 x 3
    shape that has none (embedded in 6 x 3), against the plain sweep at the
    problem's own size, to phase 3's tolerances: f64 kernel vs plain; f32
    kernel and f32 plain each against the plain sweep in f64. Each is also
    compared with the parent's launch on the same inputs (`embed` into
    12 x 12, the 12 x 12 instantiation), and the elements that differ are
    counted. Returns (the f32 kernel's largest absolute error, {shape tag:
    [elements that differ, elements]})."""
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    worst_f32, differ = 0.0, {}
    families = SINGLE_FAMILIES + (("random", 5, 3),)
    for dtype in (torch.float32, torch.float64):
        for family, ne, nu in families:
            for horizon in SINGLE_CHECKED_N:
                for batch in SINGLE_CHECKED_B:
                    args = (_random_first_pass(ne, nu, horizon, batch, dtype, device)
                            if family == "random"
                            else _family_first_pass(family, horizon, batch, dtype, device))
                    _check(args[0].shape == (horizon, ne, ne, batch)
                           and args[1].shape == (horizon, ne, nu, batch), f"{family}: shapes")
                    before = rs.riccati_sweep.launches
                    got = rs.riccati_sweep(*args)
                    torch.cuda.synchronize()
                    _check(rs.riccati_sweep.launches == before + 1, "riccati_sweep did not launch")
                    _check(got[0].shape == (horizon, nu, ne, batch)
                           and got[1].shape == (horizon, nu, batch), f"{family}: output shapes")
                    want = rs.riccati_sweep_ref(*(t.double() for t in args))
                    size = rs.instantiation(ne, nu)
                    how = ("at its own size" if size == (ne, nu)
                           else f"embedded in {_k1_tag(*size)}")
                    tag = (f"riccati_sweep {str(dtype)[6:]} {family} ne={ne} nu={nu} "
                           f"N={horizon} B={batch}")
                    line, worst = _hold(got, want, dtype, tag)
                    n_diff, n_all = _differ(got, _embedded(rs, args))
                    counts = differ.setdefault(f"{_k1_tag(ne, nu)} {str(dtype)[6:]}", [0, 0])
                    counts[0] += n_diff
                    counts[1] += n_all
                    print(f"[kernel] {tag} ({how}) vs plain f64 at its own size, max|err|/scale: "
                          f"{line}; {n_diff} of {n_all} elements differ from the 12x12 launch "
                          f"on embed's inputs")
                    if dtype == torch.float32:
                        _hold(rs.riccati_sweep_ref(*args), want, dtype, f"plain {tag}")
                        worst_f32 = max(worst_f32, worst)
    return worst_f32, differ


def _bicycle_cross(horizon, batch, dtype, device):
    """(K1 inputs, luxs) of the mixed-row bicycle fleet's backward pass."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.solver import fleet

    spec, prob, lam, rho = examples.bicycle_mixed_rows(batch, horizon, dtype, device)
    xs = fleet.open_loop_rollout(spec, prob, prob.us_init)
    *exps, luxs = fleet.knot_expansions_with_cross(spec, prob, xs, prob.us_init, lam, rho)
    lxN, lxxN = fleet.terminal_expansion(spec, xs[-1], prob, lam, rho)
    reg = torch.full((batch,), 1e-8, dtype=dtype, device=device)
    return [t.contiguous() for t in (*exps, lxN, lxxN, reg)], luxs.contiguous()


def _go1_cross(batch, dtype, device):
    """(K1 inputs, luxs) of the Go1 fleet's first pass with 16 drawn rows G =
    [Gx Gu] a knot at penalty rho, all active: lxx gains rho·GxᵀGx, luu
    rho·GuᵀGu and lux = rho·GuᵀGx, so the joint Hessian gains rho·GᵀG and
    stays positive semi-definite (more rows than inputs: Quu is then
    well-conditioned, and f32 is held as elsewhere)."""
    from quaternion_mpc_tpu_torch.solver import fleet

    args = _sweep_inputs(batch, dtype, device)
    gen = torch.Generator(device=device).manual_seed(batch)
    draw = lambda *shape: torch.randn(shape, generator=gen, dtype=dtype, device=device)
    Gx, Gu = draw(HORIZON, 16, 12, batch), draw(HORIZON, 16, 12, batch)
    rho = 0.05 * args[3].abs().amax()
    args[3] = (args[3] + rho * fleet.bmm(fleet.bt(Gx), Gx)).contiguous()
    args[5] = (args[5] + rho * fleet.bmm(fleet.bt(Gu), Gu)).contiguous()
    return args, (rho * fleet.bmm(fleet.bt(Gu), Gx)).contiguous()


def _cross_term_cases(dtype, device):
    """(tag, (ne, nu), K1 inputs, luxs) with a cross term that is not zero:
    the mixed-row bicycle fleet's backward pass (at its own 4 x 2), and the
    Go1 fleet's first pass with drawn rows that mix state and inputs
    (12 x 12)."""
    for horizon in CROSS_CHECKED_N:
        for batch in CROSS_CHECKED_B:
            args, luxs = _bicycle_cross(horizon, batch, dtype, device)
            yield f"bicycle ne=4 nu=2 N={horizon} B={batch}", (4, 2), args, luxs
    for batch in (7, 4096):
        args, luxs = _go1_cross(batch, dtype, device)
        yield f"go1 ne=12 nu=12 N={HORIZON} B={batch}", (12, 12), args, luxs


# K1 timed at each instantiation, at the shapes of paths that run it: (tag,
# dtype, maker of (inputs, luxs or None) on the card). 12 x 12 itself is
# phase 6's (`K1_TIMED`).
def _k1_timed_shapes():
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.solver import al_ilqr

    def cat(batch, dtype, device):
        spec, prob, _ = examples.falling_cat_fleet(batch, dtype, device, seed=0)
        return _first_pass(al_ilqr.lift_problem(prob), al_ilqr.fleet_spec(spec)), None

    def family(name, horizon, batch):
        return lambda dtype, device: (
            _family_first_pass(name, horizon, batch, dtype, device), None)

    return (
        ("falling_cat ne=6 nu=3 N=40 B=4096", torch.float32, lambda d, dev: cat(4096, d, dev)),
        ("falling_cat ne=6 nu=3 N=40 B=1", torch.float64, lambda d, dev: cat(1, d, dev)),
        ("humanoid ne=12 nu=6 N=20 B=1", torch.float32, family("humanoid", 20, 1)),
        ("humanoid ne=12 nu=6 N=20 B=256", torch.float32, family("humanoid", 20, 256)),
        ("double_integrator ne=4 nu=2 N=20 B=4096", torch.float32,
         family("double_integrator", 20, 4096)),
        ("pendulum ne=2 nu=1 N=20 B=4096", torch.float32, family("pendulum", 20, 4096)),
        ("bicycle lux ne=4 nu=2 N=30 B=1", torch.float64,
         lambda d, dev: _bicycle_cross(30, 1, d, dev)),
        ("bicycle lux ne=4 nu=2 N=30 B=4096", torch.float32,
         lambda d, dev: _bicycle_cross(30, 4096, d, dev)),
        ("go1 lux ne=12 nu=12 N=10 B=4096", torch.float32, lambda d, dev: _go1_cross(4096, d, dev)),
    )


def phase_k1_shape_timing(device):
    """K1 at each instantiation (`_k1_timed_shapes`), by CUDA events around a
    replayed graph of 20 calls of the wrapper: the launch at the problem's own
    size, and the parent's launch of the same problem (`embed`'s pads into
    12 x 12 and the 12 x 12 instantiation; the live block is a view), in turns
    (own, embedded, own, embedded), and the 12 x 12 launch alone on the
    padded inputs; each beside the bound of the function at its own size; the
    plain version (eager). Returns {tag: {...}}."""
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    out = {}
    for tag, dtype, make in _k1_timed_shapes():
        args, luxs = make(dtype, device)
        horizon, ne, nu, batch = args[0].shape[0], args[0].shape[1], args[1].shape[2], args[0].shape[-1]
        lux = luxs is not None
        own = lambda: rs.riccati_sweep(*args, luxs=luxs)
        embedded = lambda: _embedded(rs, args, luxs)
        big = rs.embed(*args, luxs=luxs)
        launch_12 = lambda: rs.riccati_sweep(*big[:9], luxs=big[9] if lux else None)
        turns = [_graph_time(fn, reps=20) * 1e3 for fn in (own, embedded, own, embedded)]
        launch_ms = _graph_time(launch_12, reps=20) * 1e3
        plain_ms = _event_time(lambda: rs.riccati_sweep_ref(*args, luxs=luxs), reps=3,
                               warmup=1) * 1e3
        bound_ms, bound_by = _bound(rs.work(horizon, batch, dtype, ne, nu, lux), dtype)
        ms, embedded_ms = (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2
        size = rs.instantiation(ne, nu, lux)
        print(f"[timing] K1 riccati_sweep {str(dtype)[6:]} {tag} at {_k1_tag(*size, lux)}: "
              f"{turns[0]:.4f} / {turns[2]:.4f} ms (graph replay), bound {bound_ms:.5f} ms by "
              f"{bound_by} for the function at its own size ({100 * bound_ms / ms:.2f}% of it "
              f"reached); the parent's launch (embed's pads, the 12x12 launch) {turns[1]:.4f} / "
              f"{turns[3]:.4f} ms ({100 * bound_ms / embedded_ms:.2f}%), the 12x12 launch alone "
              f"{launch_ms:.4f} ms; plain {plain_ms:.3f} ms")
        out[f"{str(dtype)[6:]} {tag}"] = {
            "instantiation": _k1_tag(*size, lux), "ms": ms, "ms_turns": turns[0::2],
            "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            "plain_ms": plain_ms, "embedded_12x12": {
                "ms": embedded_ms, "ms_turns": turns[1::2], "launch_alone_ms": launch_ms,
                "share_of_bound": bound_ms / embedded_ms}}
        del args, luxs, big
    return out




def phase_cross_term_vs_plain(device):
    """K1's instantiation with the cost's cross term (Qux = lux + BᵀVxxA)
    through its wrapper against `riccati_sweep_ref(..., luxs=...)` at the
    problem's own size, to phase 3's tolerances; each case must also differ
    from the sweep without the cross term. The bicycle's launches (at its own
    4 x 2) are compared with the parent's (embedded in 12 x 12) and the
    elements that differ counted. Returns (the f32 kernel's largest absolute
    error, {shape tag: [elements that differ, elements]})."""
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    worst_f32, differ = 0.0, {}
    for dtype in (torch.float32, torch.float64):
        for tag, (ne, nu), args, luxs in _cross_term_cases(dtype, device):
            horizon, batch = args[0].shape[0], args[0].shape[-1]
            _check(luxs.shape == (horizon, nu, ne, batch) and bool((luxs != 0).any()),
                   f"{tag}: the cross term is zero or misshapen")
            before = rs.riccati_sweep.launches
            got = rs.riccati_sweep(*args, luxs=luxs)
            torch.cuda.synchronize()
            _check(rs.riccati_sweep.launches == before + 1, "riccati_sweep did not launch")
            _check(got[0].shape == (horizon, nu, ne, batch), f"{tag}: output shapes")
            want = rs.riccati_sweep_ref(*(t.double() for t in args), luxs=luxs.double())
            without = rs.riccati_sweep_ref(*(t.double() for t in args))
            moved = ((want[0] - without[0]).abs().max() / want[0].abs().max()).item()
            _check(moved > 1e-3, f"{tag}: the cross term moves the gains by {moved:.1e} only")
            line, worst = _hold(got, want, dtype, f"riccati_sweep {str(dtype)[6:]} with lux, {tag}")
            embedded = ""
            if (ne, nu) != (12, 12):
                n_diff, n_all = _differ(got, _embedded(rs, args, luxs))
                counts = differ.setdefault(f"{_k1_tag(ne, nu, True)} {str(dtype)[6:]}", [0, 0])
                counts[0] += n_diff
                counts[1] += n_all
                embedded = f"; {n_diff} of {n_all} elements differ from the 12x12 launch on embed's inputs"
            tag = f"riccati_sweep {str(dtype)[6:]} with lux, {tag}"
            print(f"[kernel] {tag} (at {_k1_tag(*rs.instantiation(ne, nu, True), True)}) vs plain "
                  f"f64 with lux at its own size (lux moves Ks by {moved:.2e} of scale), "
                  f"max|err|/scale: {line}{embedded}")
            if dtype == torch.float32:
                _hold(rs.riccati_sweep_ref(*args, luxs=luxs), want, dtype, f"plain {tag}")
                worst_f32 = max(worst_f32, worst)
    return worst_f32, differ


def _counted(fn, what, want_k1, want_k2, path=None, instantiation="quat_srb_midpoint",
             solves=None):
    """fn() with the kernels' counts set to 0 just before and read just
    after: exactly ``want_k1`` K1 and ``want_k2`` K2 launches (al x ilqr for
    a solve of a model K2 has, 0 for the bicycle's), no K4, and as many K8
    launches as K2's (every model K2 has, K8 has), K9's rollout once a solve
    (``solves``, where given) and its pricing al + 1 times (`_k2_count`);
    K1 at the problem's own size (`riccati_sweep.embed` never called);
    ``path`` names the K2, K8 and K9 launches of ``instantiation`` in the
    kernels line. Returns (fn's result, the K1 count as read)."""
    from quaternion_mpc_tpu_torch.kernels import assoc_scan as k4
    from quaternion_mpc_tpu_torch.kernels import line_search as k2
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    embeds, real_embed = [], rs.embed

    def embed(*args, **kwargs):  # every problem of these paths has an instantiation of its own
        embeds.append(args[0].shape)
        return real_embed(*args, **kwargs)

    rs.riccati_sweep.launches = k4.assoc_backward.launches = k4.assoc_scan.launches = 0
    k2.line_search.launches = _k8().launches = 0
    _zero_k9()
    rs.embed = embed
    try:
        out = fn()
    finally:
        rs.embed = real_embed
    torch.cuda.synchronize()
    got = (rs.riccati_sweep.launches, k4.assoc_backward.launches, k4.assoc_scan.launches,
           k2.line_search.launches, _k8().launches)
    want = (want_k1, 0, 0, want_k2, want_k2)
    _check(got == want,
           f"{what}: (K1, assoc_backward, assoc_scan, K2, K8) launches {got}, expected {want}")
    _check(not embeds, f"{what}: K1 embedded {len(embeds)} launches ({embeds[:1]}): the path's "
                       f"problem has an instantiation of its own")
    if path is not None:
        _k2_count(path, got[3], instantiation, k8=got[4], solves=solves)
    return out, got[0]


def _hold_fixture(name, batch, device, path=None):
    """A golden C++ fixture at default options in f64, one problem (batch 0)
    or a fleet of ``batch`` copies, against the JSON at the JAX test's bounds
    (K2 al x ilqr times: the quaternion SRB's instantiation in the quaternion
    fixtures, the Euler SRB's forward-Euler one in the convex fixture).
    Returns the K1 launches of the solve, as counted."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.solver import al_ilqr
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    opts = SolverOptions()
    spec, prob, gold_us, gold_xs, atol_us, atol_xs = examples.fixture_problem(
        name, torch.float64, device)
    if batch:
        prob = al_ilqr.broadcast_problem(prob, batch)
    per_solve = opts.al_iterations * opts.ilqr_iterations
    sol, k1 = _counted(lambda: al_ilqr.make_solver(spec, opts)(prob),
                       f"{name} fixture B={batch or 1}", per_solve, per_solve, path=path, solves=1,
                       instantiation="euler_srb_euler" if name == "convex" else
                       "quat_srb_midpoint")
    us, xs = sol.us.cpu().numpy(), sol.xs.cpu().numpy()[..., : len(gold_xs), :]
    us_err, xs_err = float(np.abs(us - gold_us).max()), float(np.abs(xs - gold_xs).max())
    _check(np.isfinite(us).all() and us_err <= atol_us and xs_err <= atol_xs,
           f"{name} fixture B={batch or 1}: us err {us_err:.3e} (tol {atol_us}), xs err "
           f"{xs_err:.3e} (tol {atol_xs})")
    print(f"[single] {name} fixture f64 {'one problem' if not batch else f'B={batch}'}, 6x10: "
          f"K1 launches {k1}, K2 {per_solve}, no K4; us err {us_err:.3e} (tol {atol_us}), xs err {xs_err:.3e} "
          f"(tol {atol_xs}), violation {float(sol.stats.constraint_violation.max()):.2e}")
    return k1


def _hold_branches(device):
    """The three branch scenarios at their own sizes and options in f64, held
    to tests/test_branch_configs.py's open-loop bounds (:73-78, :124-129,
    :182-191). `solve_scenario` keeps its solve's CUDA graph for later calls
    with the same arguments: its first call launches each kernel al x ilqr
    times in each of the GRAPH_WARMUP warm-up solves and in the replay, a
    second call al x ilqr times (one replay of the kept graph) and gives the
    first's solution bit for bit."""
    from quaternion_mpc_tpu_torch import scenarios
    from quaternion_mpc_tpu_torch.utils.graphs import GRAPH_WARMUP

    weight = 12.84 * 9.81  # spider_dog's, carried by friction on the walls
    for name, per_solve in (("falling_cat", 75), ("humanoid", 60), ("spider_dog", 60)):
        first = (GRAPH_WARMUP + 1) * per_solve
        (sol, summary), k1 = _counted(
            lambda: scenarios.solve_scenario(name, dtype=torch.float64, device=device),
            f"{name} solve, its first call", first, first,
            instantiation="attitude_midpoint" if name == "falling_cat" else "quat_srb_midpoint")
        (again, summary2), k1_again = _counted(
            lambda: scenarios.solve_scenario(name, dtype=torch.float64, device=device),
            f"{name} solve, a second call", per_solve, per_solve,
            instantiation="attitude_midpoint" if name == "falling_cat" else "quat_srb_midpoint")
        _check(all(torch.equal(a, b) for a, b in zip(_tensors(again), _tensors(sol)))
               and summary2 == summary, f"{name}: the second call's solution differs from "
                                        f"the first's")
        us, xs = sol.us.cpu().numpy(), sol.xs.cpu().numpy()
        _check(np.isfinite(us).all() and np.isfinite(xs).all(), f"{name}: non-finite solution")
        if name == "falling_cat":
            norms = np.linalg.norm(xs[:, 0:4], axis=-1)
            _check(summary["attitude_error"] < 1e-3 and summary["max_input"] <= 8.0 + 1e-4
                   and np.abs(norms - 1.0).max() <= 5e-3,
                   f"falling_cat: {summary}, |q| within {np.abs(norms - 1.0).max():.2e}")
        elif name == "humanoid":
            fz = us[0].reshape(2, 3)[:, 2]
            _check(summary["attitude_error"] < 2e-4 and summary["constraint_violation"] < 1e-6
                   and abs(fz[0] - fz[1]) <= 0.2 * abs(fz[1]), f"humanoid: {summary}, fz {fz}")
        else:
            f = us[0].reshape(4, 3)
            press = -f[:, 1] * np.array([1, -1, 1, -1])
            _check(summary["constraint_violation"] < 1e-6
                   and abs(f[:, 2].sum() - weight) <= 1e-3 * weight
                   and (press > 1.0).all() and (np.abs(f[:, 2]) <= 0.7 * press + 1e-5).all()
                   and np.abs(xs[-1, 7:13]).max() <= 1e-3, f"spider_dog: {summary}, f {f}")
        print(f"[single] {name} f64, its own options, replayed from a CUDA graph: K1 launches "
              f"{k1} in the first call ({GRAPH_WARMUP} warm-ups, one replay; K2 and K8 as many), "
              f"{k1_again} in a second (a replay of the kept graph, the same bits), no K4; "
              + ", ".join(f"{k} {v:.3e}" for k, v in summary.items()))


def _worker_single_quality(device):
    """Worker: the golden fixtures (one problem and B=256) and the branch
    scenarios, each solve counted and held to its bound."""
    for name in ("quat", "trot", "convex"):
        for batch in (0, 256):
            _hold_fixture(name, batch, device)
    _hold_branches(device)


def _worker_cat_loop(device):
    """Worker: `make_receding_step("falling_cat")` in f64 to tick 50, its tick
    replayed from a CUDA graph, exactly 16 K1 and 16 K2 launches a tick, one
    eager tick under set_sync_debug_mode("error"); the
    reference's bounds at tick 50 (error < 0.05) and on the torque box."""
    from quaternion_mpc_tpu_torch import scenarios
    from quaternion_mpc_tpu_torch.utils.graphs import Graphed

    step, carry = scenarios.make_receding_step("falling_cat", dtype=torch.float64, device=device)
    # as `scenarios.run_closed_loop` runs it: the tick a CUDA graph, replayed
    # with the carry chained in its buffers; tick 2 runs the eager step
    graph = Graphed(step, chain=True)
    graph.captured(carry)
    errs, u_max = [], []
    t0 = time.perf_counter()
    for tick in range(CAT_LOOP_TICKS):
        if tick == 2:  # warm: no build, no first-use setup left
            torch.cuda.synchronize()
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                carry, m = step(carry)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        else:
            (carry, m), _ = _counted(lambda: graph(carry), f"falling_cat tick {tick}", 16, 16,
                                     instantiation="attitude_midpoint")
        errs.append(m["att_err"])
        u_max.append(m["u_max"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / CAT_LOOP_TICKS * 1e3
    errs, u_hi = torch.stack(errs).cpu().numpy(), float(torch.stack(u_max).max())
    _check(np.isfinite(errs).all() and bool(torch.isfinite(carry[0]).all()),
           "falling_cat loop: non-finite state")
    _check(errs[50] < 0.05 and u_hi <= 8.2,
           f"falling_cat loop: att_err at tick 50 {errs[50]:.3e} (bound 0.05), max torque {u_hi:.3f}")
    print(f"[single] falling_cat receding loop f64, 2x8 a tick, {CAT_LOOP_TICKS} ticks replayed "
          f"from a CUDA graph: K1 and K2 "
          f"launches 16/tick each, no K4, tick 2 under set_sync_debug_mode('error'): no synchronising call; "
          f"att_err {errs[0]:.3f} -> {errs[25]:.3e} (tick 25) -> {errs[50]:.3e} (tick 50, bound "
          f"0.05), max torque {u_hi:.3f} N*m (box 8, bound 8.2); {ms:.1f} ms/tick beside the "
          f"other workers")


CAT_TORQUE_BOX = 8.0
# Three AL rounds leave the torque box violated: in f64 by up to 0.06 in a few
# percent of starts, in f32 by more (a B=4096 fleet on an H100: 1,342 starts
# above 8.0001, 38 above 8.2, the largest 9.47). Every start that does not
# run away is held under the ceiling, and 98% of them under the near bound.
CAT_TORQUE_NEAR, CAT_TORQUE_CEILING = 8.2, 10.0
# The reference's own test vouches for a start at 160 degrees
# (tests/test_branch_configs.py:60-78). The falling_cat cost w(1 - |q_ref.q|)
# is unbounded below in |q|, which the midpoint rule inflates at high rates,
# and from some starts beyond that angle the line search finds that descent
# within a few iterations and runs away (|q| in the hundreds or more, a cost
# far below zero): in the JAX solver too, in f64 too
# (tests/test_torch_al_ilqr.py holds both packages to it on two starts of
# this fleet). Which of the steep starts tip over depends on rounding (on an
# H100 the f64 fleet lost 626, 2739, 3174 and 3925, at 166-171 degrees, the
# f32 fleet 626 and 2616), so the gate is set by the start, not by the result:
# no start up to CAT_VOUCHED_DEG may run away, a steeper one either meets
# every bound or is far off the sphere, and few are.
CAT_VOUCHED_DEG = 160.0
# The falling_cat fleet's figures with the plain expansions (PR 15-17 on an
# H100): its starts of at most CAT_VOUCHED_DEG that hold (all 3,281 of the
# seed's), and the starts that run away in f32 and in f64; printed beside
# this run's, not held.
CAT_PARENT = {"source": "PR 15 W1, PR 17 F1", "quality": 3281, "f32": [626, 2610, 2616],
              "f64": [626, 2739, 3174, 3925]}
CAT_FAR_OFF = 10.0  # a runaway's |q|; between 1.005 and this a start fails
CAT_MAX_RUNAWAYS = 0.002  # of the fleet


def _hold_cat_fleet(sol, prob, what, torque_ceiling):
    """Hold a falling_cat fleet's solution to the gate above. Returns
    (runaway starts, the held starts' mask, geodesic error, |torque| max per
    start, | |q| - 1 | max per start, start angle in degrees), in f64."""
    b = sol.xs.shape[0]
    q_end, q_ref = sol.xs[:, -1, 0:4].double(), prob.cost.x_ref[:, -1, 0:4].double()
    geodesic = 1.0 - torch.abs(torch.sum(q_end * q_ref, dim=-1))
    u_hi = sol.us.abs().amax(dim=(1, 2)).double()
    norm_err = (torch.linalg.norm(sol.xs[..., 0:4].double(), dim=-1) - 1.0).abs().amax(dim=1)
    angle = 2.0 * torch.rad2deg(torch.acos(prob.x0[:, 0].double().clamp(-1.0, 1.0)))
    _check(bool(torch.isfinite(sol.xs).all() and torch.isfinite(sol.us).all()),
           f"{what}: non-finite solution")
    away = norm_err > 5e-3
    ids = torch.nonzero(away)[:, 0].tolist()
    _check(not bool((away & (angle <= CAT_VOUCHED_DEG)).any()),
           f"{what}: a start of at most {CAT_VOUCHED_DEG} degrees left the unit sphere: starts "
           f"{ids} at {[round(a, 1) for a in angle[away].tolist()]} degrees")
    _check(not bool((away & (norm_err + 1.0 < CAT_FAR_OFF)).any()),
           f"{what}: | |q| - 1 | between 5e-3 and {CAT_FAR_OFF}, neither held nor a runaway: "
           f"{norm_err[away].tolist()} in starts {ids}")
    _check(len(ids) <= CAT_MAX_RUNAWAYS * b,
           f"{what}: {len(ids)} runaway starts > {CAT_MAX_RUNAWAYS:.1%} of {b}")
    held = ~away
    geo_max, u_max = float(geodesic[held].max()), float(u_hi[held].max())
    _check(geo_max < 1e-3, f"{what}: geodesic error {geo_max:.3e} >= 1e-3")
    _check(u_max <= torque_ceiling, f"{what}: |torque| {u_max:.4f} above {torque_ceiling}")
    return ids, held, geodesic, u_hi, norm_err, angle


def phase_cat_fleet(device, smi):
    """A falling_cat fleet, B=4096, f32, N=40, 3 AL x 25 iLQR, 12 alphas:
    starts at 100-175 degrees about seeded axes. One counted warm-up solve
    (exactly 75 K1, 75 K2 and 75 K8 launches, K2's and K8's attitude
    instantiations), p50 / min / max of 3 more, the quality of the fleet's
    optimum and of one f64 solve of the same starts (printed beside the
    parent's figures, CAT_PARENT). K1 alone at this shape is phase 6's
    (`phase_k1_shape_timing`). Returns a dict for the kernels line."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.solver import al_ilqr

    b, dtype = CAT_FLEET_B, torch.float32
    spec, prob, opts = examples.falling_cat_fleet(b, dtype, device, seed=0)
    per_solve = opts.al_iterations * opts.ilqr_iterations
    solver = al_ilqr.make_solver(spec, opts)
    sol, k1_launches = _counted(lambda: solver(prob), f"falling_cat fleet B={b}", per_solve,
                                per_solve, path="falling_cat_fleet_3x25_B4096",
                                instantiation="attitude_midpoint", solves=1)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        sol = solver(prob)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    p50 = statistics.median(times)
    print(f"[single] falling_cat fleet f32 B={b}, N=40, 3x25, 12 alphas: K1, K2 and K8 launches "
          f"{k1_launches}, {per_solve} and {per_solve} a solve, no K4; p50 {p50 * 1e3:.1f} ms (min {min(times) * 1e3:.1f}, max "
          f"{max(times) * 1e3:.1f}; 3 solves after 1 warm-up), {b / p50:,.0f} solves/s; {smi}")
    # Quality: the gate of `_hold_cat_fleet`, on the f32 fleet and on one f64
    # solve of the same starts (the reference's bounds for its one start are
    # geodesic error < 1e-3, |torque| <= 8.0001, | |q| - 1 | <= 5e-3).
    _, prob64, _ = examples.falling_cat_fleet(b, torch.float64, device, seed=0)
    sol64, _ = _counted(lambda: al_ilqr.make_solver(spec, opts)(prob64),
                        f"falling_cat fleet f64 B={b}", per_solve, per_solve,
                        path="falling_cat_fleet_3x25_B4096_f64", instantiation="attitude_midpoint",
                        solves=1)
    away64, held64, geo64, u64, norm64, _ = _hold_cat_fleet(
        sol64, prob64, "falling_cat fleet f64", CAT_TORQUE_NEAR)
    away, held, geodesic, u_hi, norm_err, angle = _hold_cat_fleet(
        sol, prob, "falling_cat fleet f32", CAT_TORQUE_CEILING)
    start = 1.0 - torch.abs(torch.sum(prob.x0[:, 0:4] * prob.cost.x_ref[:, -1, 0:4], dim=-1))
    geo_max, u_max = float(geodesic[held].max()), float(u_hi[held].max())
    vouched = held & (angle <= CAT_VOUCHED_DEG)
    over_test = int((u_hi[held] > CAT_TORQUE_BOX + 1e-4).sum())
    over_near = int((u_hi[held] > CAT_TORQUE_NEAR).sum())
    degrees = lambda ids: [round(float(angle[i]), 1) for i in ids]
    print(f"[single] falling_cat fleet quality: {int((angle <= CAT_VOUCHED_DEG).sum())} starts of at "
          f"most {CAT_VOUCHED_DEG:g} degrees, none may run away; of the {int((angle > CAT_VOUCHED_DEG).sum())} "
          f"steeper ones the f32 fleet runs away in {away} (at {degrees(away)} degrees, |q| up to "
          f"{float(norm_err.max()) + 1:.3g}), the f64 solve of the same starts in {away64} (at "
          f"{degrees(away64)} degrees, |q| up to {float(norm64.max()) + 1:.3g}; elsewhere geodesic "
          f"error max {float(geo64[held64].max()):.3e}, max |torque| {float(u64[held64].max()):.4f}, "
          f"bound {CAT_TORQUE_NEAR}); the other {int(held.sum())} f32 starts: final geodesic error "
          f"mean {float(geodesic[held].mean()):.3e}, max {geo_max:.3e} (from {float(start.min()):.3f}-"
          f"{float(start.max()):.3f}; bound 1e-3), | |q| - 1 | up to "
          f"{float(norm_err[held].max()):.2e} (bound 5e-3), max |torque| {u_max:.4f} "
          f"({float(u_hi[vouched].max()):.4f} up to {CAT_VOUCHED_DEG:g} degrees; box "
          f"{CAT_TORQUE_BOX:g}, ceiling {CAT_TORQUE_CEILING:g}): {over_test} above the one-start "
          f"test's 8.0001, {over_near} above {CAT_TORQUE_NEAR}; live iterations "
          f"{int(sol.stats.iterations.min())}-{int(sol.stats.iterations.max())} of {per_solve}")
    _check(over_near <= 0.02 * b,
           f"falling_cat fleet f32: {over_near} starts above a torque of {CAT_TORQUE_NEAR}")
    quality = int((held & (angle <= CAT_VOUCHED_DEG)).sum())
    print(f"[single] falling_cat fleet beside the parent's (the plain expansions; "
          f"{CAT_PARENT['source']}): starts of at most {CAT_VOUCHED_DEG:g} degrees that hold "
          f"{quality} (parent {CAT_PARENT['quality']}), runaway starts f32 {away} (parent "
          f"{CAT_PARENT['f32']}), f64 {away64} (parent {CAT_PARENT['f64']})")
    del sol64, prob64
    # A whole solve is ~75 iterations of one body; its trace would hold half a
    # million kernel records. The profiled solve is 1 AL x 5 iLQR of the same
    # body, its busy share against its own unprofiled p50.
    short = al_ilqr.make_solver(spec, opts._replace(al_iterations=1, ilqr_iterations=5))
    short_s = _sync_time(lambda: short(prob), runs=3, warmup=1)
    try:
        _profile_once(lambda: short(prob), f"falling_cat fleet B={b} solve cut to 1x5", short_s)
    except RuntimeError as e:  # a record, not a check: the tracer may be unavailable
        print(f"[profile] falling_cat fleet solve not measured: {e}")

    return dict(k1_launches=k1_launches, p50=p50, min=min(times), max=max(times),
                geodesic_max=geo_max, torque_max=u_max, runaways=away,
                runaways_f64=away64)


def phase_single_counted(device):
    """In the main process, counts set to 0 just before each and read just
    after: one default solve (the quat fixture, 6 x 10: 60 K1 launches), one
    of the convex fixture (60 K1 and 60 K2, forward Euler), one falling_cat
    receding tick (2 x 8: 16 K1 and 16 K2), and the bicycle's receding solves
    (state rows Cx, so K1 takes the cross term lux; 2 x 8: 16 each). Returns
    the K1 launches as counted: (of the default solve, of the tick, of the
    bicycle's solves together)."""
    from quaternion_mpc_tpu_torch import examples, scenarios
    from quaternion_mpc_tpu_torch.models import classic, discretize
    from quaternion_mpc_tpu_torch.solver import al_ilqr

    solve_k1 = _hold_fixture("quat", 0, device, path="make_solver_default_6x10_quat_fixture")
    # the golden convex fixture (forward Euler): its K2 instantiation counted here too
    _hold_fixture("convex", 0, device, path="make_solver_default_6x10_convex_fixture")
    step, carry = scenarios.make_receding_step("falling_cat", dtype=torch.float64, device=device)
    (carry, m), tick_k1 = _counted(lambda: step(carry), "falling_cat tick", 16, 16,
                                   path="falling_cat_receding_tick_2x8",
                                   instantiation="attitude_midpoint", solves=1)
    _check(bool(torch.isfinite(carry[0]).all()), "falling_cat tick: non-finite state")
    print(f"[single] one falling_cat receding tick f64: K1 and K2 launches {tick_k1} each, att_err "
          f"{float(m['att_err']):.4f}, max torque {float(m['u_max']):.3f}")

    spec, opts, build, x_ref, u_ref, params, h, delta_max = examples.bicycle_tracking(
        torch.float64, device)
    per_solve = opts.al_iterations * opts.ilqr_iterations
    solver = al_ilqr.make_solver(spec, opts)
    x, us_warm = x_ref[0], u_ref[0].expand(30, 2)
    errs, bicycle_k1 = [], 0
    for k in range(BICYCLE_TICKS):
        sol, k1 = _counted(lambda: solver(build(k, x, us_warm)), f"bicycle tick {k}", per_solve,
                           0)
        bicycle_k1 += k1
        errs.append(float(torch.sum((x - x_ref[k]) ** 2)))
        x = discretize.midpoint_step(classic.bicycle_dynamics, x, sol.us[0], params, h)
        us_warm = torch.cat([sol.us[1:], sol.us[-1:]])
        _check(bool(torch.isfinite(x).all()) and abs(float(x[3])) <= delta_max + 1e-3,
               f"bicycle tick {k}: state {x.tolist()}")
    _check(max(errs) < 1e-3, f"bicycle: tracking error {max(errs):.3e} >= 1e-3")
    print(f"[single] bicycle (scotty) f64, N=30, 2x8, {BICYCLE_TICKS} receding solves: state rows "
          f"Cx, the backward pass is K1 with the cross term lux, K1 launches {per_solve} a solve "
          f"({bicycle_k1} in all), no K4; steering within its bound, tracking error up to "
          f"{max(errs):.2e}")
    return solve_k1, tick_k1, bicycle_k1


# ---------------------------------------------------------------------------
# Phase 13: the joint-level (articulated) tier, K7, and the per-scenario steps
# ---------------------------------------------------------------------------

ACT_B = 64            # `cli run_actuated --batch` (the CLI's default)
ACT_BIG_B = 4096
ACT_N_SUB = 80        # `cli run_actuated --n_sub`
ACT_STATE_TICKS = 25  # the mixed trot that gives K7's check its states
ACT_QUALITY_TICKS = 300
ACT_TAIL = 150        # the ticks the JAX tests' bounds average over
K7_CHECKED_B = (1, 7, 4096)
# K7 timed alone: from one scenario to four times the checked states (tiled),
# where the latency of one scenario's chain gives way to the card's throughput
K7_TIMED_B = (1, ACT_B, 512, ACT_BIG_B, 16384)
# --kernels-only: the block sizes tried (lanes a block, -DK7_THREADS) and the
# shapes at which they, a baseline source and the clock split are measured
K7_BLOCK_SIZES = (32, 64, 128)
K7_COMPARED_B = (ACT_B, ACT_BIG_B)
# K7 against the plain step (its f64 run), over each leaf's scale. f64: two
# formulations of M and c (closed forms against torch.func), 80 substeps.
# f32: a stick / slip decision at the friction cone's edge may flip in f32
# rounding itself; in such a scenario the f32 plain step leaves the f64 one
# as well, and K7 in f32 is held to the f32 plain step there, with at most
# K7_F32_FLIP_SHARE of the scenarios so treated.
K7_TOL = {torch.float64: 1e-9, torch.float32: 1e-3}
K7_F32_FLIP_SHARE = 0.05
# card against CPU, f64, over the per-scenario SRB steps' few ticks
SINGLE_TICKS = 3


def _act_opts():
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    return SolverOptions(al_iterations=2, ilqr_iterations=4)  # the actuated steps' default


def _drive_actuated(step, carry, sp, joy, ticks, what, sync=False, args=(), record=None,
                    path=None):
    """``ticks`` ticks of an actuated step, each launching K7 exactly once
    and K1 and K2 al x ilqr (8) times each, K4 never; the counts set to 0
    just before and read just after; ``record(carry, metrics)`` after each
    tick; ``path`` names the K2 launches in the kernels line. Returns
    (carry, metrics of every tick, tick seconds when ``sync``, K7 launches,
    K1 launches)."""
    from quaternion_mpc_tpu_torch.kernels import articulated as k7
    from quaternion_mpc_tpu_torch.kernels import assoc_scan as k4
    from quaternion_mpc_tpu_torch.kernels import line_search as k2
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    opts = _act_opts()
    per_solve = opts.al_iterations * opts.ilqr_iterations
    per_tick = (1, per_solve, 0, per_solve, per_solve)
    k7.articulated_step.launches = rs.riccati_sweep.launches = k4.assoc_backward.launches = 0
    k2.line_search.launches = _k8().launches = _k10().launches = _k11().launches = 0
    _zero_k9()
    counters = (k7.articulated_step, rs.riccati_sweep, k4.assoc_backward, k2.line_search, _k8())
    metrics, times = [], []
    for tick in range(ticks):
        before = [c.launches for c in counters]
        t0 = time.perf_counter()
        carry, m = step(carry, sp, joy, *args)
        if sync:
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        got = tuple(c.launches - n for c, n in zip(counters, before))
        _check(got == per_tick, f"{what} tick {tick}: (K7, K1, K4, K2, K8) launches {got}, "
                                f"expected {per_tick}")
        metrics.append(m)
        if record is not None:
            record(carry, m)
    torch.cuda.synchronize()
    _check(_k10().launches == 0, f"{what}: K10 launched {_k10().launches} times on the "
                                 f"actuated path (its pre is the plain version's)")
    _check(_k11().launches == 0, f"{what}: K11 launched {_k11().launches} times on the "
                                 f"actuated path (its plant is K7)")
    if path is not None:
        _k2_count(path, k2.line_search.launches, k8=_k8().launches, solves=ticks)
    return carry, metrics, times, k7.articulated_step.launches, rs.riccati_sweep.launches


def _rows(tree, b, dtype):
    """The first b scenarios of a batch-leading tree (or a plain tuple of
    them), floating leaves cast."""
    from quaternion_mpc_tpu_torch.utils.tree import tree_map

    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return tuple(_rows(part, b, dtype) for part in tree)
    return tree_map(lambda a: (a[:b].to(dtype) if a.is_floating_point() else a[:b]).contiguous(),
                    tree)


def _scenario_err(got, want, relative=True):
    """Per scenario, the largest error of any leaf, over that leaf's scale
    (its largest magnitude over the batch, at least 1) when ``relative``."""
    from quaternion_mpc_tpu_torch.utils.tree import tree_leaves

    errs = []
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        w = w.double()
        scale = max(1.0, w.abs().max().item()) if relative else 1.0
        errs.append((g.double() - w).abs().reshape(w.shape[0], -1).amax(1) / scale)
    return torch.stack(errs).amax(0)


def _k7_states(device, trot_ticks):
    """K7's check and timing inputs, f64, K7_CHECKED_B[-1] scenarios:
    the mixed fleet (flat, onto the slope, up to a stair riser) after
    ``trot_ticks`` of the actuated trot in f32 on the card (launches
    counted), each robot's state perturbed by seeded noise (numpy seed 7),
    targets drawn around the joints. Returns ((state, targets, params, dt),
    K7 and K1 launches of the trot)."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.control.torque import JointTargets
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.sim.plant import PlantState

    b, f64 = K7_CHECKED_B[-1], torch.float64
    carry, sp, joy = examples.actuated_mixed(b, torch.float32, device)
    k7_n = k1_n = 0
    if trot_ticks:
        step = rt.make_actuated_walking_step(HORIZON, _act_opts(), n_sub=ACT_N_SUB)
        carry, _, _, k7_n, k1_n = _drive_actuated(step, carry, sp, joy, trot_ticks,
                                                  "actuated mixed trot",
                                                  path="actuated_mixed_trot_2x4_B4096")
        _check(_all_finite(carry.robot), "actuated mixed trot: non-finite state")
        print(f"[actuated] mixed trot f32 B={b} (flat, slope, stairs), {trot_ticks} ticks: K7 "
              f"1/tick, K1 and K2 8/tick each; alive {int(carry.alive.sum())}/{b}")
    rng = np.random.default_rng(7)
    noise = lambda shape, std: torch.from_numpy(std * rng.standard_normal(shape)).to(device)
    rs = _rows(carry.robot, b, f64)
    torso = rs.torso
    rs = rs._replace(
        torso=PlantState(pos=torso.pos, quat=torso.quat, vel=torso.vel + noise((b, 3), 0.1),
                         omega=torso.omega + noise((b, 3), 0.2)),
        q=rs.q + noise((b, 4, 3), 0.03), dq=rs.dq + noise((b, 4, 3), 0.5),
        anchor=rs.anchor + noise((b, 4, 3), 0.002))
    targets = JointTargets(q=rs.q + noise((b, 4, 3), 0.05), dq=noise((b, 4, 3), 0.5),
                           tau=noise((b, 4, 3), 4.0))
    return (rs, targets, _rows(sp.plant, b, f64), sp.wts.h[:b].double()), (k7_n, k1_n)


def phase_k7_vs_plain(device, states):
    """K7 against the plain step (`sim.articulated.step`, backend "plain",
    on the card) at B in K7_CHECKED_B, f64 and f32, n_sub = 80. Returns
    (the f32 kernel's max |err| against the f64 plain step outside the
    flipped scenarios, the f64 kernel's max |err|, the flips' count)."""
    from quaternion_mpc_tpu_torch.kernels import articulated as k7
    from quaternion_mpc_tpu_torch.sim import articulated as art

    s, tg, ap, dt = states
    b_max = K7_CHECKED_B[-1]
    t0 = time.perf_counter()
    plain = {dtype: art.step(*_rows((s, tg, ap), b_max, dtype), dt.to(dtype), ACT_N_SUB,
                             backend="plain") for dtype in (torch.float64, torch.float32)}
    torch.cuda.synchronize()
    print(f"[K7] plain steps f64 and f32 at B={b_max} on the card: "
          f"{time.perf_counter() - t0:.1f} s")
    plain_err = _scenario_err(plain[torch.float32], plain[torch.float64])
    flipped = plain_err > K7_TOL[torch.float32]
    n_flipped = int(flipped.sum())
    _check(n_flipped <= K7_F32_FLIP_SHARE * b_max,
           f"K7: f32 leaves f64 in {n_flipped} of {b_max} scenarios of the plain step itself")
    worst_abs = {}
    for dtype in (torch.float64, torch.float32):
        for b in K7_CHECKED_B:
            inputs = _rows((s, tg, ap), b, dtype)
            before = k7.articulated_step.launches
            got = k7.articulated_step(*inputs, dt[:b].to(dtype), ACT_N_SUB)
            torch.cuda.synchronize()
            _check(k7.articulated_step.launches == before + 1, "articulated_step did not launch")
            want = _rows(plain[torch.float64], b, torch.float64)
            err = _scenario_err(got, want)
            abs_err = _scenario_err(got, want, relative=False)
            tag = f"articulated_step {str(dtype)[6:]} B={b} n_sub={ACT_N_SUB}"
            if dtype == torch.float64:
                worst = err.max().item()
                worst_abs[dtype] = max(worst_abs.get(dtype, 0.0), abs_err.max().item())
                line = f"max|err|/scale {worst:.3e} (tol {K7_TOL[dtype]})"
            else:
                flips = flipped[:b]
                against32 = _scenario_err(got, _rows(plain[torch.float32], b, torch.float32))
                err = torch.where(flips, against32, err)
                worst = err.max().item()
                kept = abs_err[~flips]
                worst_abs[dtype] = max(worst_abs.get(dtype, 0.0),
                                       kept.max().item() if kept.numel() else 0.0)
                line = (f"max|err|/scale {worst:.3e} (tol {K7_TOL[dtype]}; {int(flips.sum())} "
                        f"scenarios whose f32 plain step flips a stick / slip decision held "
                        f"to the f32 plain step)")
            _check(worst <= K7_TOL[dtype], f"{tag}: {line}")
            print(f"[K7] {tag} vs plain: {line}")
    print(f"[K7] the f32 plain step leaves the f64 one beyond {K7_TOL[torch.float32]} of scale "
          f"in {n_flipped} of {b_max} scenarios (a stick / slip flip at the cone's edge), "
          f"elsewhere by at most {plain_err[~flipped].max().item():.3e}")
    return worst_abs[torch.float32], worst_abs[torch.float64], n_flipped


def _k7_packed(states, b, dtype):
    """K7's packed rows for b scenarios: the first b of the checked states,
    tiled beyond their number."""
    from quaternion_mpc_tpu_torch.kernels import articulated as k7

    s, tg, ap, dt = states
    n = min(b, K7_CHECKED_B[-1])
    rows = k7.pack(*_rows((s, tg, ap), n, dtype), dt[:n].to(dtype))
    if b > n:
        idx = torch.arange(b, device=dt.device) % n
        rows = tuple(r[idx].contiguous() for r in rows)
    return rows


def phase_k7_timing(device, states):
    """K7 alone by CUDA events around a replayed graph of launches on packed
    rows, at B in K7_TIMED_B, f32 and f64, beside its bound; one plain step
    at B=64 f32 for the record. Returns {shape: row}."""
    from quaternion_mpc_tpu_torch.kernels import articulated as k7
    from quaternion_mpc_tpu_torch.sim import articulated as art

    s, tg, ap, dt = states
    rows = {}
    for dtype in (torch.float32, torch.float64):
        for b in K7_TIMED_B:
            packed = _k7_packed(states, b, dtype)
            ms = _graph_time(lambda: k7.launch(*packed, ACT_N_SUB), reps=20) * 1e3
            bound_ms, bound_by = _bound(k7.work(ACT_N_SUB, b, dtype), dtype)
            row = dict(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                       share_of_bound=bound_ms / ms)
            if (dtype, b) == (torch.float32, ACT_B):
                inputs = _rows((s, tg, ap), b, dtype)
                row["plain_ms"] = _sync_time(
                    lambda: art.step(*inputs, dt[:b].to(dtype), ACT_N_SUB, backend="plain"),
                    runs=2, warmup=1) * 1e3
            tag = f"{str(dtype)[6:]} B={b} n_sub={ACT_N_SUB}"
            rows[tag] = row
            plain = f", plain step {row['plain_ms']:.1f} ms" if "plain_ms" in row else ""
            print(f"[K7] articulated_step {tag}: {ms:.4f} ms a launch (graph of 20), bound "
                  f"{bound_ms:.5f} ms by {bound_by} ({100 * row['share_of_bound']:.3f}% of it; "
                  f"{-(-b // (k7.THREADS // 4))} blocks of {k7.THREADS} lanes){plain}")
    return rows


def _k7_launcher(lib, packed):
    """(run, out): run() launches ``lib``'s K7 entry on ``packed`` into out on
    the current stream, uncounted."""
    state, targets, params = packed
    out = torch.empty_like(state)
    fn = getattr(lib, f"articulated_step_{'f64' if state.dtype == torch.float64 else 'f32'}")

    def run():
        err = fn(state.data_ptr(), targets.data_ptr(), params.data_ptr(), out.data_ptr(),
                 ACT_N_SUB, state.shape[0], torch.cuda.current_stream().cuda_stream)
        _check(err == 0, f"K7 launch failed with CUDA error {err}")

    return run, out


def _rows_err(got, want):
    """Largest |got − want| over the largest |want| (at least 1), K7's rows."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp(min=1.0)).item()


def phase_k7_designs(states, baseline=None):
    """--kernels-only: K7 built at each block size of K7_BLOCK_SIZES
    (-DK7_THREADS), with nvcc's default fused multiply-add in place of its
    FLAGS ("contracted") and, given ``baseline`` (another source of the
    kernel with the same C interface: the previous design), that source,
    timed in turns (forward, then backward) by events around a replayed
    graph at K7_COMPARED_B, f32 and f64; each build's rows held against the
    shipped kernel's (the block size changes no arithmetic; the contracted
    build's and the baseline's differences are printed). Then the
    -DK7_PHASE_CLOCKS build: the clocks of each phase of a substep, lane 0
    of the middle block."""
    from quaternion_mpc_tpu_torch.kernels import articulated as k7
    from quaternion_mpc_tpu_torch.kernels import build as kbuild

    builds = {f"threads={n}": lambda n=n: k7.build((f"-DK7_THREADS={n}",))
              for n in K7_BLOCK_SIZES}
    builds["contracted"] = lambda: kbuild.build(k7.SOURCE)
    builds["clocks"] = lambda: k7.build(("-DK7_PHASE_CLOCKS",))
    if baseline:  # as that design was built
        builds["baseline"] = lambda: kbuild.build(pathlib.Path(baseline).resolve())
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        paths = dict(zip(builds, pool.map(lambda build: build(), builds.values())))
    print(f"[K7] {len(paths)} more builds in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        for k in kbuild.ptxas_report(path):
            print(f"[K7] ptxas {name} {k['name'][-30:]}: {k['registers']} registers, "
                  f"{k['stack']} bytes stack, spill {k['stores']} / {k['loads']} bytes")
    libs = {name: k7.bind(path) for name, path in paths.items()}
    timed = [name for name in builds if name != "clocks"]
    for dtype in (torch.float32, torch.float64):
        for b in K7_COMPARED_B:
            packed = _k7_packed(states, b, dtype)
            want = k7.launch(*packed, ACT_N_SUB)
            runs = {name: _k7_launcher(libs[name], packed) for name in timed}
            times = {name: [] for name in timed}
            for name in timed + timed[::-1]:
                times[name].append(_graph_time(runs[name][0], reps=20) * 1e3)
            bound_ms, _ = _bound(k7.work(ACT_N_SUB, b, dtype), dtype)
            parts = []
            for name in timed:
                err = _rows_err(runs[name][1], want)
                if name.startswith("threads="):
                    _check(err <= K7_TOL[dtype], f"K7 {name} {dtype} B={b}: {err:.3e} from "
                                                 f"the shipped build")
                ms = times[name]
                share = 100 * bound_ms / statistics.mean(ms)
                parts.append(f"{name} {ms[0]:.4f} / {ms[1]:.4f} ms ({share:.3f}% of the bound; "
                             f"{err:.1e} from the shipped build)")
            print(f"[K7] designs {str(dtype)[6:]} B={b} n_sub={ACT_N_SUB}, in turns forward / "
                  f"backward: " + "; ".join(parts))
    clocks = libs["clocks"]
    clocks.articulated_clocks.argtypes = [ctypes.c_void_p]
    clocks.articulated_clocks.restype = ctypes.c_int
    for dtype in (torch.float32, torch.float64):
        for b in K7_COMPARED_B:
            packed = _k7_packed(states, b, dtype)
            run, out = _k7_launcher(clocks, packed)
            run()
            err = _rows_err(out, k7.launch(*packed, ACT_N_SUB))
            _check(err <= K7_TOL[dtype], f"K7 clocks build {dtype} B={b}: {err:.3e} off")
            got = np.zeros(len(k7.PHASES) + 1, dtype=np.int64)
            _check(clocks.articulated_clocks(got.ctypes.data) == 0, "reading K7's clocks failed")
            per = got[:-1] / ACT_N_SUB
            print(f"[K7] clocks a substep {str(dtype)[6:]} B={b} (lane 0 of the middle block; two "
                  f"stamps back to back {got[-1]}): {per.sum():.0f} in all: "
                  + ", ".join(f"{name} {c:.0f}" for name, c in zip(k7.PHASES, per)))


def _actuated_quality(device, dtype, batch, kf_type):
    """ACT_QUALITY_TICKS ticks of the CLI's actuated fleet at 0.4 m/s
    (examples.actuated_batch), each launching K7 once and K1 8 times, held
    in every robot to the JAX tests' bounds. kf_type None, ground-truth
    feedback (test_actuated.py:60-78): alive, the mean forward velocity over
    the last 150 ticks within 0.12 of 0.4 m/s, the mean height within 0.05 m
    of 0.3 m, x > 0.8 m, the joints moving (max |dq| > 0.1). kf_type 1, the
    BasicKF in the loop (test_estimated_actuated.py:29-45): alive, the
    velocity bound, x > 0.8 m, the mean est_err over the last 150 ticks <
    0.05 m, the joints moving. The tick is replayed from a CUDA graph."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.utils.graphs import Graphed
    from quaternion_mpc_tpu_torch.runtime import step as rt

    if kf_type is None:
        step = rt.make_actuated_walking_step(HORIZON, _act_opts(), n_sub=ACT_N_SUB)
        what = f"actuated trot {str(dtype)[6:]} B={batch}"
    else:
        step = rt.make_estimated_actuated_step(HORIZON, _act_opts(), kf_type=kf_type,
                                               n_sub=ACT_N_SUB)
        what = f"actuated BasicKF trot {str(dtype)[6:]} B={batch}"
    carry, sp, joy = examples.actuated_batch(batch, dtype, device, kf_type=kf_type, velx=0.4)
    vel_x, height, est_err = [], [], []

    def record(c, m):  # the carry is the graph's buffer: its rows are copied
        vel_x.append(c.robot.torso.vel[:, 0].clone())
        height.append(c.robot.torso.pos[:, 2].clone())
        if kf_type is not None:
            est_err.append(m.est_err)

    # the tick replayed as `cli run_actuated` replays it
    graph = Graphed(step, chain=True)
    graph.captured(carry, sp, joy)
    what += ", replayed from a CUDA graph"
    t0 = time.perf_counter()
    carry, _, _, _, _ = _drive_actuated(graph, carry, sp, joy, ACT_QUALITY_TICKS, what,
                                        record=record)
    ms = (time.perf_counter() - t0) / ACT_QUALITY_TICKS * 1e3
    vel = torch.stack(vel_x[-ACT_TAIL:]).mean(0)
    h = torch.stack(height[-ACT_TAIL:]).mean(0)
    x = carry.robot.torso.pos[:, 0]
    dq = carry.robot.dq.abs().flatten(1).amax(1)
    _check(bool(carry.alive.all()), f"{what}: {int((~carry.alive).sum())} robots down")
    _check(_all_finite(carry.robot), f"{what}: non-finite state")
    _check((vel - 0.4).abs().max().item() <= 0.12,
           f"{what}: mean velocity {vel.min().item():.4f}-{vel.max().item():.4f} m/s")
    _check(x.min().item() > 0.8, f"{what}: min x {x.min().item():.3f} m <= 0.8")
    _check(dq.min().item() > 0.1, f"{what}: joints still (max |dq| {dq.min().item():.3f})")
    line = ""
    if kf_type is None:
        _check((h - 0.3).abs().max().item() < 0.05,
               f"{what}: mean height {h.min().item():.4f}-{h.max().item():.4f} m")
        line = f", mean height {h.min().item():.4f}-{h.max().item():.4f} m"
    else:
        e = torch.stack(est_err[-ACT_TAIL:]).mean(0)
        _check(e.max().item() < 0.05, f"{what}: mean est_err up to {e.max().item():.4f} m")
        line = f", mean est_err up to {e.max().item():.5f} m"
    print(f"[actuated] {what}, 2x4, n_sub={ACT_N_SUB}, {ACT_QUALITY_TICKS} ticks at 0.4 m/s: "
          f"K7 1/tick, K1 8/tick, all alive; x {x.min().item():.4f}-{x.max().item():.4f} m; "
          f"last {ACT_TAIL} ticks' mean velocity {vel.min().item():.4f}-{vel.max().item():.4f} "
          f"m/s{line}; {ms:.1f} ms/tick over the run")


# The actuated quality runs, host-bound and held to bounds only, run as
# worker processes beside phase 13's untimed checks.
ACT_WORKERS = {  # the longest first
    "actuated-basickf-f32": lambda device: _actuated_quality(device, torch.float32, ACT_B, 1),
    "actuated-trot-f32": lambda device: _actuated_quality(device, torch.float32, ACT_B, None),
    "actuated-trot-f64": lambda device: _actuated_quality(device, torch.float64, 4, None),
}


def phase_single_srb(device):
    """The per-scenario SRB steps (`make_standing_step`, `make_walking_step`,
    `make_estimated_standing_step`, `make_estimated_walking_step` with the
    BasicKF), one robot unbatched, f64: SINGLE_TICKS ticks on the card, each
    launching K1 al x ilqr times (standing 10, walking 8) and K4 never,
    against the same ticks on the CPU (plant within F64_PLANT_TOL, costs
    within 1e-6 of scale). Returns the K1 launches counted."""
    from quaternion_mpc_tpu_torch.control import quat_mpc
    from quaternion_mpc_tpu_torch.models import srb
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions
    from quaternion_mpc_tpu_torch.utils import config as cfg

    f64 = torch.float64
    stand, walk = SolverOptions(al_iterations=2, ilqr_iterations=5), _act_opts()

    def wts(dev):
        return quat_mpc.weights_from_config(cfg.gazebo_go1_quat_mpc(), dtype=f64, device=dev)

    def feet(dev):
        return srb.go1_params(dtype=f64, device=dev).foot_pos

    def joy(dev, velx):
        return rt.neutral_joy(f64, dev)._replace(velx=torch.full((), velx, dtype=f64, device=dev))

    cases = (
        ("standing 2x5", rt.make_standing_step(HORIZON, stand), stand,
         lambda dev: rt.init_scenario(wts(dev), feet(dev), dtype=f64, device=dev), 0.0),
        ("walking 2x4", rt.make_walking_step(HORIZON, walk), walk,
         lambda dev: rt.init_walking_scenario(wts(dev), dtype=f64, device=dev), 0.3),
        ("estimated standing 2x5", rt.make_estimated_standing_step(HORIZON, stand), stand,
         lambda dev: rt.init_estimated_scenario(wts(dev), feet(dev), dtype=f64, device=dev), 0.0),
        ("estimated walking BasicKF 2x4", rt.make_estimated_walking_step(HORIZON, walk), walk,
         lambda dev: rt.init_estimated_walking_scenario(wts(dev), dtype=f64, device=dev), 0.3),
    )
    total = 0
    for what, step, opts, init, velx in cases:
        per_tick = opts.al_iterations * opts.ilqr_iterations
        runs = []
        for dev in (device, torch.device("cpu")):
            carry, sp = init(dev)
            j = joy(dev, velx)
            ticks = []
            for _ in range(SINGLE_TICKS):
                if dev.type == "cuda":
                    k10_before, k11_before = _k10().launches, _k11().launches
                    (carry, m), k1 = _counted(lambda: step(carry, sp, j), f"{what} B=1", per_tick,
                                              per_tick, path="per_scenario_srb_steps_B1",
                                              solves=1)
                    total += k1
                    # the walking steps' pre is K10, once a tick; the standing steps' plain;
                    # every step's post is K11, once a tick
                    k10 = _k10().launches - k10_before
                    k11 = _k11().launches - k11_before
                    _check(k10 == ("walking" in what) and k11 == 1,
                           f"{what} B=1: (K10, K11) launches {(k10, k11)} a tick")
                    _k10_count(f"per-scenario {what} step B=1", k10)
                    _k11_count(f"per-scenario {what} step B=1", k11)
                else:
                    carry, m = step(carry, sp, j)
                ticks.append((carry, m))
            runs.append(ticks)
        plant_err = cost_err = 0.0
        for (cu, mu), (cp, mp) in zip(*runs):
            _check(tuple(cu.plant.pos.shape) == (3,) and bool(cu.alive.cpu() == cp.alive),
                   f"{what}: unbatched shapes or alive differ")
            plant_err = max(plant_err, max((a.cpu() - b).abs().max().item()
                                           for a, b in zip(cu.plant, cp.plant)))
            cost_err = max(cost_err, abs(mu.mpc_cost.item() - mp.mpc_cost.item())
                           / max(1.0, abs(mp.mpc_cost.item())))
        _check(plant_err <= F64_PLANT_TOL and cost_err <= 1e-6,
               f"{what} card vs CPU: plant {plant_err:.3e}, cost {cost_err:.3e}")
        print(f"[single] {what} f64 one robot (unbatched), {SINGLE_TICKS} ticks: K1 and K2 "
              f"launches {per_tick}/tick each, no K4; card vs CPU max|plant err| {plant_err:.3e} (tol "
              f"{F64_PLANT_TOL}), cost {cost_err:.2e} of scale")
    return total


def phase_actuated(device, smi):
    """Phase 13: K7's states from a mixed trot; the quality workers started,
    and beside them K7 against the plain step and the per-scenario SRB
    steps card against CPU; then, with no worker running, K7 alone by CUDA
    events, the CLI's actuated fleet (one Go1 tiled, f32, 2x4, n_sub=80, 0.4
    m/s) at B=64 and B=4096 (p50 / min / max of 10 ticks after 3 warm-ups,
    exactly 1 K7 and 8 K1 a tick), one plain-plant tick, a profile split by
    range, and a tick of each actuated step under
    `set_sync_debug_mode("error")`. Returns a dict for the kernels line."""
    from quaternion_mpc_tpu_torch import examples
    from quaternion_mpc_tpu_torch.control.torque import JointTargets
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.sim import articulated as art

    t_phase = time.perf_counter()
    states, (trot_k7, trot_k1) = _k7_states(device, ACT_STATE_TICKS)
    workers = _start_workers(ACT_WORKERS)
    try:
        worst_f32, worst_f64, flips = phase_k7_vs_plain(device, states)
        single_k1 = phase_single_srb(device)
    finally:
        _join_workers(workers)
    t_checks = time.perf_counter()
    timing = phase_k7_timing(device, states)

    step = rt.make_actuated_walking_step(HORIZON, _act_opts(), n_sub=ACT_N_SUB)
    fleets, k7_fleet, k1_fleet = {}, 0, 0
    for b in (ACT_B, ACT_BIG_B):
        carry, sp, joy = examples.actuated_batch(b, torch.float32, device)
        carry, _, _, k7_n, k1_n = _drive_actuated(step, carry, sp, joy, 3, f"actuated B={b} warm-up",
                                                  path="actuated_cli_fleet_2x4_B64_B4096")
        carry, _, times, k7_t, k1_t = _drive_actuated(step, carry, sp, joy, 10,
                                                      f"actuated B={b} timed", sync=True,
                                                      path="actuated_cli_fleet_2x4_B64_B4096")
        k7_fleet, k1_fleet = k7_fleet + k7_n + k7_t, k1_fleet + k1_n + k1_t
        _check(bool(carry.alive.all()) and _all_finite(carry.robot), f"actuated B={b}: down")
        p50 = statistics.median(times)
        fleets[b] = dict(p50=p50, min=min(times), max=max(times), carry=carry, sp=sp, joy=joy)
        print(f"[actuated] CLI fleet f32 B={b}, 2x4, n_sub={ACT_N_SUB} at 0.4 m/s: K7 1/tick, "
              f"K1 and K2 8/tick each, K4 0; p50 {p50 * 1e3:.2f} ms/tick (min {min(times) * 1e3:.2f}, max "
              f"{max(times) * 1e3:.2f}; 10 ticks after 3 warm-ups), {b / p50:,.0f} robot-ticks/s;"
              f" {smi}")
    one = fleets[ACT_B]
    c, sp, joy = one["carry"], one["sp"], one["joy"]
    hold = JointTargets(q=c.robot.q, dq=torch.zeros_like(c.robot.q), tau=torch.zeros_like(c.robot.q))
    plain_s = _sync_time(lambda: art.step(c.robot, hold, sp.plant, sp.wts.h, ACT_N_SUB,
                                          backend="plain"), runs=1, warmup=1)
    print(f"[actuated] one plain-plant control period at B={ACT_B} f32 (the torch.func leg "
          f"dynamics, eager): {plain_s * 1e3:.1f} ms, against K7's "
          f"{timing[f'float32 B={ACT_B} n_sub={ACT_N_SUB}']['ms']:.3f} ms")
    try:
        profile = _profile_tick(lambda: step(c, sp, joy), one["p50"],
                                f"B={ACT_B} actuated tick (2x4, n_sub={ACT_N_SUB})",
                                (rt.PRE, rt.SOLVE, rt.POST))
    except RuntimeError as e:  # a record, not a check: the tracer may be unavailable
        print(f"[profile] actuated tick not measured: {e}")
        profile = None
    _no_sync_tick(lambda: step(c, sp, joy), f"B={ACT_B} actuated", "actuated")
    for kf_type in (1, 2):
        est_step = rt.make_estimated_actuated_step(HORIZON, _act_opts(), kf_type=kf_type,
                                                   n_sub=ACT_N_SUB, mocap_every=1,
                                                   mocap_warmup=0)
        ec, esp, ejoy = examples.actuated_batch(ACT_B, torch.float32, device, kf_type=kf_type)
        ec, _ = est_step(ec, esp, ejoy, True)
        mocap = torch.ones(ACT_B, dtype=torch.bool, device=device)
        _no_sync_tick(lambda: est_step(ec, esp, ejoy, mocap),
                      f"B={ACT_B} estimated actuated kf_type {kf_type}"
                      + (" (mocap sample due and fused)" if kf_type == 2 else ""), "actuated")
    print(f"[actuated] phase wall {time.perf_counter() - t_phase:.1f} s (checks beside "
          f"{len(ACT_WORKERS)} quality workers {t_checks - t_phase:.1f} s)")
    return dict(worst_f32=worst_f32, worst_f64=worst_f64, flips=flips, timing=timing,
                fleets={b: {k: v for k, v in f.items() if k in ("p50", "min", "max")}
                        for b, f in fleets.items()},
                profile=profile, plain_tick_ms=plain_s * 1e3, single_k1=single_k1,
                k7_launches={"actuated_mixed_trot_B4096": trot_k7,
                             "actuated_cli_fleet_ticks_B64_B4096": k7_fleet},
                k1_launches={"actuated_mixed_trot_B4096": trot_k1,
                             "actuated_cli_fleet_ticks_B64_B4096": k1_fleet})


# ---------------------------------------------------------------------------
# Phase 14: the host side (runtime.hardware_loop, the CLI), K1 in the tick,
# K7 in the peer
# ---------------------------------------------------------------------------

HW_DT = 0.02            # the loop's requested 50 Hz
HW_TARGET_H = 0.3
HW_FLOW_N_SUB = 160     # the sync flows' plant: 160 x 0.125 ms a 20 ms tick
HW_PEER_DT, HW_PEER_N_SUB = 0.004, 32  # the threaded loop's peer: a 250 Hz servo period
# K7's launches on this path: (n_sub, dt) of the peer's period and of the sync flows' tick
HW_K7_SHAPES = ((HW_PEER_N_SUB, HW_PEER_DT), (HW_FLOW_N_SUB, HW_DT))
HW_CHECKED_LEAD = 0.02  # the pool's publish lead, also checked card against CPU
HW_TIMED_TICKS = 10
# tests/test_hardware_loop.py's flows: (horizon, al, ilqr, label script)
HW_STAND = (6, 1, 3, [("prime", 25), ("stand", 60)])
HW_WALK = (8, 2, 3, [("prime", 25), ("stand", 25), ("walk", 80), ("stand after walk", 50)])


def _hw_setup(device, dtype):
    """The loop's Go1 (gazebo quat preset), flat ground, standing at 0.3 m."""
    from quaternion_mpc_tpu_torch.control import quat_mpc
    from quaternion_mpc_tpu_torch.sim import articulated as art
    from quaternion_mpc_tpu_torch.sim import terrain
    from quaternion_mpc_tpu_torch.utils import config as cfg

    wts = quat_mpc.weights_from_config(cfg.gazebo_go1_quat_mpc(), dtype=dtype, device=device)
    ap = art.default_params(wts.mass, wts.inertia, wts.com_offset, wts.trunk_mass,
                            terrain.make_terrain("flat", dtype=dtype, device=device), dtype, device)
    rs = art.init_state(height=HW_TARGET_H, rho_fix=ap.rho_fix, dtype=dtype, device=device)
    return wts, ap, rs


def _hw_counters():
    """(K1, K7, K4's fused entry, K2, K8, K9's rollout, K9's pricing)."""
    from quaternion_mpc_tpu_torch.kernels import articulated as k7
    from quaternion_mpc_tpu_torch.kernels import assoc_scan as k4
    from quaternion_mpc_tpu_torch.kernels import line_search as k2
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    return (rs.riccati_sweep, k7.articulated_step, k4.assoc_backward, k2.line_search, _k8(),
            *_k9())


def _hw_counts():
    return tuple(c.launches for c in _hw_counters())


def _hw_zero_counts():
    for c in _hw_counters():
        c.launches = 0


def _hw_sync_flow(device, flow, record=None):
    """One of the JAX tests' operator flows tick by tick on the card: the
    tick (K1, K2 and K8 al x ilqr times each), then the peer's period (one K7) under its
    command, the sensors observed from the new state. Returns per-tick host
    values and the counts; ``record(k, label, (carry, sensors, dt, joy),
    (state, cmd_mat))`` sees each tick's inputs and the peer's."""
    from quaternion_mpc_tpu_torch.control import goals
    from quaternion_mpc_tpu_torch.runtime import hardware_loop as hw
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

    horizon, al, ilqr, phases = flow
    tick = hw.make_hw_control_tick(horizon, SolverOptions(al_iterations=al, ilqr_iterations=ilqr))
    dtype = torch.float32
    wts, ap, rs = _hw_setup(device, dtype)
    sensors = hw.split_sensors(hw.observe(rs, rs, ap, HW_DT))
    carry = hw.init_hw_carry(sensors, ap.rho_fix, HW_TARGET_H, window=25)
    neutral = goals.neutral_joy_sample(dtype, device)
    press = torch.ones((), dtype=torch.bool, device=device)
    velx = torch.full((), 0.3, dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    dt = torch.full((), HW_DT, dtype=dtype, device=device)
    starts, k0 = {}, 0
    for label, n in phases:
        starts[label] = k0
        k0 += n
    labels = [label for label, n in phases for _ in range(n)]
    out = []
    _hw_zero_counts()
    for k, label in enumerate(labels):
        first = starts[label] == k
        if label in ("prime", "stand") and first and (label == "prime" or labels[k - 1] == "prime"):
            joy = neutral._replace(default_pos=press)            # B on / B off
        elif label in ("walk", "stand after walk") and first:
            joy = neutral._replace(mode_switch=press,            # A on / A off
                                   velx=velx if label == "walk" else zero)
        elif label == "walk":
            joy = neutral._replace(velx=velx)
        else:
            joy = neutral
        before = _hw_counts()
        carry_in = carry
        carry, cmd, info = tick(carry, sensors, dt, joy, wts, ap.rho_fix, ap.kp_joint,
                                ap.kd_joint)
        mid = _hw_counts()
        if record is not None:
            record(k, label, (carry_in, sensors, dt, joy), (rs, cmd))
        rs_prev = rs
        rs, obs = hw.peer_step(rs, cmd, ap, HW_DT, HW_FLOW_N_SUB)
        after = _hw_counts()
        got = (mid[0] - before[0], mid[1] - before[1], after[1] - mid[1], after[0] - mid[0],
               after[2] - before[2], mid[3] - before[3], after[3] - mid[3],
               mid[4] - before[4], after[4] - mid[4], mid[5] - before[5], mid[6] - before[6],
               after[5] + after[6] - mid[5] - mid[6])
        want = (al * ilqr, 0, 1, 0, 0, al * ilqr, 0, al * ilqr, 0, 1, al + 1, 0)
        _check(got == want,
               f"hardware flow tick {k}: (K1 in the tick, K7 in the tick, K7 in the peer, K1 in "
               f"the peer, K4, K2 in the tick, K2 in the peer, K8 in the tick, K8 in the peer, "
               f"K9's rollout and pricing in the tick, K9 in the peer) launches {got}, expected "
               f"{want}")
        sensors = hw.split_sensors(obs)
        host = torch.cat([info["est_pos"], rs.torso.pos, rs.torso.vel, rs.torso.quat[:1],
                          info["in_prime"].to(dtype)[None], info["movement_mode"].to(dtype)[None]])
        h = host.cpu().numpy().astype(np.float64)
        out.append(dict(label=label, est=h[0:3], pos=h[3:6], vel=h[6:9], qw=abs(h[9]),
                        in_prime=bool(h[10]), mode=int(h[11])))
    return out, rs, ap, wts, carry, tick, _hw_counts()


def _hw_weight_share(rs, ap, wts):
    from quaternion_mpc_tpu_torch.sim import articulated as art

    _, fw, fv, _ = art.foot_kinematics(rs, ap)
    f, _ = art.contact_forces(fw, fv, ap, rs.anchor)
    return float(f[:, 2].sum()) / (float(wts.mass) * 9.81)


def phase_hw_stand_flow(device):
    """test_hardware_loop.py:87-151 on the card: B, 25 prime ticks, B, 60
    ticks of MPC stand (horizon 6, 1 x 3)."""
    t0 = time.perf_counter()
    ticks, rs, ap, wts, carry, tick, counts = _hw_sync_flow(device, HW_STAND)
    n_prime = HW_STAND[3][0][1]
    _check(all(t["in_prime"] for t in ticks[:n_prime]) and
           not any(t["in_prime"] for t in ticks[n_prime:]), "hardware stand flow: prime phases")
    prime_err = float(np.linalg.norm(ticks[n_prime - 1]["est"] - ticks[n_prime - 1]["pos"]))
    drift = float(np.linalg.norm((ticks[-1]["pos"] - ticks[n_prime]["pos"])[:2])) / (
        (len(ticks) - n_prime) * HW_DT)
    final_err = float(np.linalg.norm(ticks[-1]["est"] - ticks[-1]["pos"]))
    weight = _hw_weight_share(rs, ap, wts)
    last = ticks[-1]
    print(f"[hardware] sync stand flow f32 (25 prime + 60 MPC ticks, horizon 6, 1x3, plant "
          f"{HW_FLOW_N_SUB} substeps a tick): KF error after prime {prime_err:.4f} m (< 0.02), "
          f"qw {last['qw']:.4f} (> 0.99), height error {abs(last['pos'][2] - HW_TARGET_H):.4f} m "
          f"(< 0.03), drift {drift:.4f} m/s (< 0.02), final KF error {final_err:.4f} m (< 0.02), "
          f"Σfz {weight:.4f} of mg (within 0.1); K1 3 a tick, K7 1 a peer step "
          f"({counts[0]} / {counts[1]}); {time.perf_counter() - t0:.1f} s")
    _check(prime_err < 0.02 and last["qw"] > 0.99 and abs(last["pos"][2] - HW_TARGET_H) < 0.03
           and drift < 0.02 and final_err < 0.02 and abs(weight - 1.0) <= 0.1,
           "hardware stand flow: outside test_hardware_loop.py's bounds")
    return counts, carry, tick


def phase_hw_walk_flow(device):
    """test_hardware_loop.py:219-292 on the card: B, prime, B, stand, A at
    0.3 m/s, 80 walking ticks, A, 50 standing ticks (horizon 8, 2 x 3). Keeps
    the inputs of a tick of each mode, and the peer's, for the card-against-
    CPU and graph-against-eager checks."""
    t0 = time.perf_counter()
    kept, peer_kept = {}, {}

    def record(k, label, tick_in, peer_in):
        if (label, "edge") not in kept:  # B on, B off, A on, A off
            kept[(label, "edge")], peer_kept[(label, "edge")] = tick_in, peer_in
        elif (label, "later") not in kept and k % 7 == 3:
            kept[(label, "later")], peer_kept[(label, "later")] = tick_in, peer_in

    ticks, rs, ap, wts, carry, tick, counts = _hw_sync_flow(device, HW_WALK, record)
    bounds = np.cumsum([n for _, n in HW_WALK[3]])
    t1, t2, t3 = bounds[:3]
    modes = [(t["in_prime"], t["mode"]) for t in ticks]
    _check(all(p for p, _ in modes[:t1]) and all((not p) and m == 0 for p, m in modes[t1:t2])
           and all((not p) and m == 1 for p, m in modes[t2:t3])
           and all((not p) and m == 0 for p, m in modes[t3:]), "hardware walk flow: phases")
    walked = ticks[t3]["pos"][0] - ticks[t2]["pos"][0]
    qw_min = min(t["qw"] for t in ticks)
    last = ticks[-1]
    final_err = float(np.linalg.norm(last["est"] - last["pos"]))
    speed = float(np.linalg.norm(last["vel"][:2]))
    print(f"[hardware] sync stand-walk-stand flow f32 (25 + 25 + 80 at 0.3 m/s + 50 ticks, "
          f"horizon 8, 2x3): walked {walked:.4f} m (> 0.2), min qw {qw_min:.4f} (> 0.95 every "
          f"tick), final height error {abs(last['pos'][2] - HW_TARGET_H):.4f} m (< 0.05), speed "
          f"{speed:.4f} m/s (< 0.15), KF error {final_err:.4f} m (< 0.08); K1 6 a tick, K7 1 a "
          f"peer step ({counts[0]} / {counts[1]}); {time.perf_counter() - t0:.1f} s")
    _check(walked > 0.2 and qw_min > 0.95 and abs(last["pos"][2] - HW_TARGET_H) < 0.05
           and speed < 0.15 and final_err < 0.08,
           "hardware walk flow: outside test_hardware_loop.py's bounds")
    return counts, kept, peer_kept, tick, (wts, ap)


def phase_hw_card_vs_cpu(device, kept, tick):
    """The walk flow's tick of each mode, from its own carry cast to f64, on
    the card against the CPU, at the publish lead 0 and 0.02: the same port
    code on two devices, so cmd_mat is held to 1e-9 of its scale (a K1 that
    rounded through f32 anywhere would leave it by ~1e-7; the two op orders
    of the JAX package and the port are held to 1e-5 on the CPU), the
    stand-up servo's rows to 1e-12."""
    from quaternion_mpc_tpu_torch.utils.tree import tree_map

    cast = lambda tree, dev: tree_map(
        lambda t: (t.double() if t.is_floating_point() else t).to(dev), tree)
    worst = 0.0
    setups = [(dev, _hw_setup(dev, torch.float64)) for dev in (device, torch.device("cpu"))]
    for (label, when), (carry, sensors, dt, joy) in sorted(kept.items()):
        for lead in (0.0, HW_CHECKED_LEAD):
            (_, card, card_info), (_, want, info) = (
                tick(cast(carry, dev), cast(sensors, dev), cast(dt, dev), cast(joy, dev), wts,
                     ap.rho_fix, ap.kp_joint, ap.kd_joint,
                     torch.full((), lead, dtype=torch.float64, device=dev))
                for dev, (wts, ap, _) in setups)
            got, prime = card.cpu(), bool(info["in_prime"])
            rtol = 1e-12 if prime else 1e-9
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            _check(bool(card_info["in_prime"]) == prime, f"hardware f64 {label}: modes")
            _check(err <= rtol * scale, f"hardware f64 {label} {when} lead {lead}: card against "
                                        f"CPU {err:.3e} > {rtol:.0e} x {scale:.3e}")
            worst = max(worst, err / scale)
    print(f"[hardware] f64 tick card against CPU from the walk flow's carries ({len(kept)} "
          f"ticks: prime, B, stand, A, walk, A, stand; lead 0 and {HW_CHECKED_LEAD}): cmd_mat "
          f"within {worst:.2e} of its scale (1e-9; the servo's rows 1e-12)")
    return worst


def _out_leaves(x):
    """The tensors of a step's outputs (trees, tuples, the info dict)."""
    from quaternion_mpc_tpu_torch.utils.tree import tree_leaves

    if isinstance(x, dict):
        return [leaf for v in x.values() for leaf in _out_leaves(v)]
    if isinstance(x, (tuple, list)) and not hasattr(x, "_fields"):
        return [leaf for v in x for leaf in _out_leaves(v)]
    return tree_leaves(x)


def _hold_equal(got, want, what):
    """Every output of a replayed graph equal to the eager call's, bit for
    bit (the same kernels in the same order); a failure names the first
    output that differs and by how much."""
    g, w = _out_leaves(got), _out_leaves(want)
    _check(len(g) == len(w), f"{what}: {len(g)} outputs replayed, {len(w)} eager")
    for i, (a, b) in enumerate(zip(g, w)):
        if not torch.equal(a, b):
            diff = float((a.double() - b.double()).abs().max()) if a.is_floating_point() else 1.0
            scale = float(b.double().abs().max()) if b.is_floating_point() else 1.0
            raise AssertionError(f"{what}: output {i} {tuple(b.shape)} {b.dtype} differs from "
                                 f"the eager call by {diff:.3e} (scale {scale:.3e})")


def phase_hw_graph_vs_eager(device, kept, peer_kept, tick, consts):
    """The loop's CUDA graphs against the eager functions on the same
    inputs (`hardware_loop.loop_step`, the peer's `period`): the walk flow's
    tick of each mode (horizon 8, 2 x 3) as the two-tier loop replays it, at
    the publish lead 0 and 0.02; its estimator and MPC tiers as the
    three-tier loop replays them; the peer's period (the threaded loop's
    n_sub 32 over 4 ms) from the flow's plant states under its commands.
    Held equal, bit for bit. Returns each graph's kernel launches a replay."""
    from quaternion_mpc_tpu_torch.runtime import hardware_loop as hw

    t0 = time.perf_counter()
    wts, ap = consts
    bound = (wts, ap.rho_fix, ap.kp_joint, ap.kd_joint)
    lead = lambda v: torch.full((), v, dtype=torch.float32, device=device)
    carry0, sensors0, dt0, joy0 = next(iter(kept.values()))
    # every graph captured before the first replay, with no other thread running
    g_tick = hw.loop_step(tick, "tick", *bound, carry0, (sensors0, dt0, joy0, lead(0.0)))
    g_est = hw.loop_step(tick, "est", *bound, carry0.kf, (sensors0, dt0))
    g_ctrl = hw.loop_step(tick, "ctrl", *bound, carry0,
                          (sensors0, carry0.kf.x[0:3], carry0.kf.x[3:6], dt0, joy0, lead(0.0)))
    peer = hw.SimGo1Peer(ap, next(iter(peer_kept.values()))[0], dt_cmd=HW_PEER_DT,
                         n_sub=HW_PEER_N_SUB)
    for (label, when), (carry, sensors, dt, joy) in sorted(kept.items()):
        for lv in (0.0, HW_CHECKED_LEAD):
            _hold_equal(g_tick(carry, sensors, dt, joy, lead(lv)),
                        tick(carry, sensors, dt, joy, *bound, lead(lv)),
                        f"hardware graphed tick {label} {when} lead {lv}")
        kf, pos, vel, _contact, _feet = tick.est_core(carry.kf, sensors, dt, ap.rho_fix)
        _hold_equal(g_est(carry.kf, sensors, dt), (kf, torch.cat([pos, vel])),
                    f"hardware graphed estimator tier {label} {when}")
        _hold_equal(g_ctrl(carry, sensors, pos, vel, dt, joy, lead(0.0)),
                    tick.ctrl_core(carry, sensors, carry.kf, pos, vel, dt, joy, *bound, lead(0.0)),
                    f"hardware graphed MPC tier {label} {when}")
    for (label, when), (state, cmd) in sorted(peer_kept.items()):
        new, obs = hw.peer_step(state, cmd, ap, HW_PEER_DT, HW_PEER_N_SUB)
        _hold_equal(peer.period(state, cmd), (new, torch.cat([obs, new.torso.pos, new.torso.vel])),
                    f"hardware graphed peer period {label} {when}")
    per_replay = {"tick_2x3": g_tick.per_replay, "estimator_tier": g_est.per_replay,
                  "mpc_tier_2x3": g_ctrl.per_replay, "peer_period": peer.period.per_replay}
    _check(per_replay == {"tick_2x3": _per_replay(2, 3), "estimator_tier": {},
                          "mpc_tier_2x3": _per_replay(2, 3),
                          "peer_period": {"articulated_step": 1}},
           f"hardware graphs: kernel launches a replay {per_replay}")
    print(f"[hardware] graphs replayed against eager calls on the walk flow's inputs ({len(kept)} "
          f"ticks of every mode; two-tier at lead 0 and {HW_CHECKED_LEAD}, both three-tier tiers; "
          f"{len(peer_kept)} peer periods at n_sub={HW_PEER_N_SUB}): every output equal, bit for "
          f"bit; launches a replay {per_replay}; {time.perf_counter() - t0:.1f} s")
    return per_replay


def _hw_timed(run):
    """HW_TIMED_TICKS warm ticks after 2, each with its pull to the host as
    the loop pays it; returns their seconds."""
    for _ in range(2):
        run()[1].cpu()
    times = []
    for _ in range(HW_TIMED_TICKS):
        t0 = time.perf_counter()
        run()[1].cpu()
        times.append(time.perf_counter() - t0)
    return times


# torch.cuda._sleep kernels launched at the start of a held trace
TRACE_MARKERS = 64


def _profile_kernels(fn, what, k1, k7, k2, k8, k9=(0, 0), traces=3):
    """The device operations of one ``fn()`` in a torch.profiler trace:
    their count and busy time, and how many are K1's, K7's, K2's, K8's and
    K9's (rollout, pricing) kernels, held to ``k1``, ``k7``, ``k2``, ``k8``
    and ``k9``. A trace can lose device records and never invents one, so a
    short count is traced again, up to ``traces`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(traces):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # the trace of the eager falling_cat solve lost its first ~24 device
            # records in every try (K9's rollout and the first K8, K1 and K2
            # among them): marker kernels, not counted, come first
            for _ in range(TRACE_MARKERS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            time.sleep(0.01)
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        ranges = _ranges(events)
        ops = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in ranges
               and "spin_kernel" not in e.name]
        got = dict(device_ops=len(ops),
                   device_busy_ms=sum(e.time_range.elapsed_us() for e in ops) / 1e3,
                   k1=sum("riccati_sweep_kernel" in e.name for e in ops),
                   k7=sum("articulated_kernel" in e.name for e in ops),
                   k2=sum("line_search_kernel" in e.name for e in ops),
                   k8=sum("expansions_kernel" in e.name for e in ops),
                   k9=(sum("rollout_kernel" in e.name for e in ops),
                       sum("price_kernel" in e.name for e in ops)), traces=len(seen) + 1)
        if (got["k1"], got["k7"], got["k2"], got["k8"], got["k9"]) == (k1, k7, k2, k8, tuple(k9)):
            return got
        seen.append(got)
    raise AssertionError(f"{what}: K1 / K7 / K2 / K8 / K9 kernels traced "
                         f"{[(g['k1'], g['k7'], g['k2'], g['k8'], g['k9']) for g in seen]} in "
                         f"{traces} traces ({[g['device_ops'] for g in seen]} device ops), {k1} / "
                         f"{k7} / {k2} / {k8} / {tuple(k9)} expected")


def _ms3(times):
    return [statistics.median(times) * 1e3, min(times) * 1e3, max(times) * 1e3]


def _hw_peer(ap, rs):
    """The loop's peer (its period captured here) and one of its periods
    under a hold command at the state's joints, as ``period()``."""
    from quaternion_mpc_tpu_torch.runtime import hardware_loop as hw

    peer = hw.SimGo1Peer(ap, rs, dt_cmd=HW_PEER_DT, n_sub=HW_PEER_N_SUB)
    hold = torch.zeros((12, 5), dtype=rs.q.dtype, device=rs.q.device)
    hold[:, 0] = rs.q.reshape(-1)
    hold[:, 3], hold[:, 4] = 100.0, 3.0
    state = [peer.state]

    def period():
        state[0], obs = peer._step(state[0], hold)
        return obs

    for _ in range(3):
        period()
    return peer, period


def _worker_hw_peer_profile(device):
    """Worker: the device operations of one graphed peer period (K7 at
    n_sub=32, the observation, one pull) in a trace, 1 K7 held, in a process
    of its own: in the long main process a trace can lose some of a graph's
    device records, the peer's K7 among them in every trace of some runs
    (complete in fresh processes; PERF.md). Prints the profile as JSON."""
    _, ap, rs = _hw_setup(device, torch.float32)
    _, period = _hw_peer(ap, rs)
    print(json.dumps({"profile": _profile_kernels(period, "hardware peer period", k1=0, k7=1,
                                                  k2=0, k8=0)}))


def _hw_beside_loop_threads(run, ap, rs):
    """The peer's graphed period alone (K7 at n_sub=32, the observation, one
    pull: host ms a 4 ms period), and the tick ``run`` beside the loop's own
    peer and a servo thread sending it a hold command at 250 Hz over UDP, as
    `run_hardware_loopback` runs them. Returns (peer ms, tick seconds, peer
    periods served meanwhile)."""
    from quaternion_mpc_tpu_torch.runtime import native, unitree

    peer, period = _hw_peer(ap, rs)
    t0 = time.perf_counter()
    for _ in range(50):
        period()
    peer_ms = (time.perf_counter() - t0) / 50 * 1e3
    q = rs.q.reshape(-1).cpu().numpy()
    stop = threading.Event()

    def servo():
        link = unitree.HardwareLink("127.0.0.1", peer.udp.local_port)
        cmd = unitree.LowCmd()
        for m, qi in zip(cmd.motor_cmd, q):
            m.q, m.Kp, m.Kd = float(qi), 100.0, 3.0
        loop = native.RateLoop(HW_PEER_DT)
        while not stop.is_set():
            loop.wait()
            link.send_cmd(cmd)
            while link.recv_state() is not None:
                pass

    servo_thread = threading.Thread(target=servo, daemon=True)
    peer.start()
    servo_thread.start()
    try:
        time.sleep(0.2)
        served0 = peer.cmds_served
        times = _hw_timed(run)
        served = peer.cmds_served - served0
    finally:
        stop.set()
        peer.stop()
        servo_thread.join(timeout=10.0)
        peer.join(timeout=10.0)
    return peer_ms, times, served


def phase_hw_tick_timing(device, carry, tick, smi):
    """The loop's warm tick (two-tier, horizon 6, 1 x 3, f32) from the stand
    flow's last carry, as the loop runs it on the card (a replayed CUDA
    graph, in a chain) and eagerly: p50 / min / max of HW_TIMED_TICKS each,
    with the pull, alone; the replayed tick beside the loop's peer and servo
    thread; the device operations of one replay in a profile (al x ilqr K1
    and K2, held) and of one peer period in a fresh process's (one K7, held:
    `--worker hardware-peer-profile`); one replay and one eager tick
    under set_sync_debug_mode."""
    from quaternion_mpc_tpu_torch.control import goals
    from quaternion_mpc_tpu_torch.runtime import hardware_loop as hw

    wts, ap, rs = _hw_setup(device, torch.float32)
    sensors = hw.split_sensors(hw.observe(rs, rs, ap, HW_DT))
    joy = goals.neutral_joy_sample(torch.float32, device)
    dt = torch.full((), HW_DT, dtype=torch.float32, device=device)
    lead0 = torch.zeros((), dtype=torch.float32, device=device)
    bound = (wts, ap.rho_fix, ap.kp_joint, ap.kd_joint)
    eager = lambda: tick(carry, sensors, dt, joy, *bound, lead0)
    graph = hw.loop_step(tick, "tick", *bound, carry, (sensors, dt, joy, lead0))
    chain = [carry]

    def replay():
        chain[0], cmd, info = graph(chain[0], sensors, dt, joy, lead0)
        return chain[0], cmd, info

    eager_times = _hw_timed(eager)
    times = _hw_timed(replay)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [eager()[1], replay()[1]]
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    _check(all(bool(torch.isfinite(c).all()) for c in outs), "hardware tick under sync debug")
    profile = _profile_kernels(replay, "hardware tick replay", k1=3, k7=0, k2=3, k8=3, k9=(1, 2))
    p50, lo, hi = _ms3(times)
    ep50, elo, ehi = _ms3(eager_times)
    print(f"[hardware] warm tick f32 (two-tier, horizon 6, 1x3, B=1, with its pull), "
          f"{HW_TIMED_TICKS} ticks after 2: replayed graph p50 {p50:.2f} ms (min {lo:.2f}, max "
          f"{hi:.2f}), eager p50 {ep50:.2f} ms (min {elo:.2f}, max {ehi:.2f}), against the 16 ms "
          f"auto_rate allows at 50 Hz; a replay traced: {profile['device_ops']} device ops, "
          f"{profile['device_busy_ms']:.2f} ms busy, {profile['k1']} K1, {profile['k2']} K2 "
          f"(trace {profile['traces']}); no synchronising call in either; {smi}")
    peer_ms, beside, served = _hw_beside_loop_threads(replay, ap, rs)
    peer_profile = _fresh("hardware-peer-profile")["profile"]
    bp50, blo, bhi = _ms3(beside)
    print(f"[hardware] the peer's graphed period alone (K7 at n_sub=32, the observation, one "
          f"pull): {peer_ms:.3f} ms of host time a 4 ms servo period, traced {peer_profile['device_ops']} "
          f"device ops, {peer_profile['device_busy_ms']:.3f} ms busy, {peer_profile['k7']} K7 "
          f"(trace {peer_profile['traces']}); the "
          f"replayed tick beside the loop's peer and servo thread over UDP ({served} peer periods "
          f"served meanwhile): p50 {bp50:.2f} ms (min {blo:.2f}, max {bhi:.2f}); {smi}")
    return dict(p50_ms=p50, min_ms=lo, max_ms=hi, eager_p50_min_max_ms=[ep50, elo, ehi],
                beside_peer_and_servo_p50_ms=bp50, beside_peer_and_servo_min_max_ms=[blo, bhi],
                peer_period_host_ms=peer_ms, replay_profile=profile,
                peer_period_profile=peer_profile)


_HW_PRINTED = ("mpc_rate_requested", "mpc_rate_used", "est_rate_used", "tick_wall_ms",
               "tick_wall_sync_ms", "est_tick_wall_ms", "prime_ticks", "mpc_ticks", "walk_ticks",
               "mpc_overruns", "servo_ticks", "servo_overruns", "servo_states", "est_updates",
               "est_overruns", "peer_cmds_served", "cmds_published", "cmds_stale_dropped",
               "publish_staleness_ms_p50", "height_err", "final_est_err", "drift_speed_mps",
               "final_quat_w", "walk_distance_m", "upright")


def _host_cpu_ticks():
    """The host's CPU time so far by kind, in ticks of /proc/stat's first
    line (user, nice, system, idle, iowait, irq, softirq, steal); None where
    the file is not there."""
    try:
        with open("/proc/stat") as f:
            return [int(v) for v in f.readline().split()[1:9]]
    except (OSError, ValueError):
        return None


def _host_cpu_share(before):
    """(busy, steal): the shares of the host's CPU time since ``before``
    (`_host_cpu_ticks`) that ran some process and that the hypervisor gave
    to another machine; (nan, nan) where /proc/stat cannot be read."""
    after = _host_cpu_ticks()
    if before is None or after is None:
        return float("nan"), float("nan")
    d = [b - a for a, b in zip(before, after)]
    total = sum(d) or 1
    return (total - d[3] - d[4] - d[7]) / total, d[7] / total


def _hw_threaded(device, what, gate, **kw):
    """One threaded `run_hardware_loopback` on the card, its K1, K2 and K8
    launches held to al x ilqr a tick call each (the captures' warm-up calls
    and the timed ticks included: a replay counts the graph's own launches)
    and its K7 launches to one a peer period (the peer's capture and first
    period included). The host's CPU shares over the run (busy, steal) are
    printed beside it and given with a bound it misses: the loop's threads
    keep the clock only when they get their cores."""
    from quaternion_mpc_tpu_torch.runtime import hardware_loop as hw

    t0 = time.perf_counter()
    _hw_zero_counts()
    cpu0 = _host_cpu_ticks()
    s = hw.run_hardware_loopback(device=device, **kw)
    busy, steal = _host_cpu_share(cpu0)
    k1, k7, k4, k2, k8, k9_roll, k9_price = _hw_counts()
    wall = time.perf_counter() - t0
    host = (f"host CPUs over the run ({os.cpu_count()}): {busy:.3f} busy, {steal:.4f} stolen, "
            f"load {' '.join(f'{v:.2f}' for v in os.getloadavg())}")
    warm = (hw.GRAPH_WARMUP + 4 + (4 if kw.get("async_mpc") else 0)
            + (8 if kw.get("async_pullers") else 0))
    n_walk = s["walk_ticks"]
    calls = warm + s["prime_ticks"] + s["mpc_ticks"] * (2 if n_walk else 1) + n_walk
    print(f"[hardware] threaded {what}: " + ", ".join(
        f"{k} {s[k]:.4g}" if isinstance(s[k], float) else f"{k} {s[k]}" for k in _HW_PRINTED)
        + f"; K1 {k1}, K2 {k2}, K8 {k8}, K9 rollout {k9_roll} and pricing {k9_price} ({calls} "
          f"tick calls), K7 {k7}; {wall:.1f} s; {host}", flush=True)
    _check(k1 == 3 * calls and k2 == 3 * calls and k8 == 3 * calls and k4 == 0
           and k9_roll == calls and k9_price == 2 * calls,
           f"hardware threaded {what}: K1 {k1}, K2 {k2}, K8 {k8}, K9 ({k9_roll}, {k9_price}) "
           f"for {calls} ticks of 1 x 3")
    _check(k7 == s["peer_cmds_served"] + 1 + hw.GRAPH_WARMUP,
           f"hardware threaded {what}: K7 {k7} for {s['peer_cmds_served']} peer periods")
    _check(s["peer_cmds_served"] > 0 and s["servo_states"] > 0
           and s["mpc_rate_used"] <= s["mpc_rate_requested"], f"hardware threaded {what}: mechanism")
    if gate:
        try:
            gate(s)
        except AssertionError as e:
            raise AssertionError(f"{e}; {host}") from None
    return s, k1, k7, (k9_roll, k9_price)


def _hold_bounds(what, bounds):
    """``bounds``: (name, measured, the JAX test's bound as text, met)."""
    line = ", ".join(f"{name} {value:.4g} ({bound})" if isinstance(value, float)
                     else f"{name} {value} ({bound})" for name, value, bound, _ in bounds)
    print(f"[hardware] {what} against the JAX tests' bounds: {line}")
    _check(all(met for *_, met in bounds), f"hardware threaded {what}: outside the bounds: {line}")


def _gate_stand(s):  # test_hardware_loop.py:292-305
    _hold_bounds("two-tier stand", [
        ("upright", s["upright"], "True", s["upright"]),
        ("mpc_rate_used", s["mpc_rate_used"], "== requested == 50.0",
         s["mpc_rate_used"] == s["mpc_rate_requested"] == 50.0),
        ("height_err", s["height_err"], "< 0.04", s["height_err"] < 0.04),
        ("final_est_err", s["final_est_err"], "< 0.03", s["final_est_err"] < 0.03),
        ("drift_speed_mps", s["drift_speed_mps"], "< 0.05", s["drift_speed_mps"] < 0.05),
        ("mpc_overruns", s["mpc_overruns"], f"<= {s['mpc_ticks'] // 5}",
         s["mpc_overruns"] <= s["mpc_ticks"] // 5)])


def _gate_walk(s):  # test_hardware_loop.py:308-327
    _hold_bounds("two-tier walk", [
        ("walk_ticks", s["walk_ticks"], "> 0", s["walk_ticks"] > 0),
        ("walk_distance_m", s["walk_distance_m"], "> 0.1", s["walk_distance_m"] > 0.1),
        ("final_est_err", s["final_est_err"], "< 0.05", s["final_est_err"] < 0.05),
        ("peer_cmds_served", s["peer_cmds_served"], "> 100", s["peer_cmds_served"] > 100),
        ("servo_states", s["servo_states"], "> 100", s["servo_states"] > 100)])


def _gate_three_tier_stand(s):  # test_hardware_loop.py:330-347
    floor = 1.5 * (s["prime_ticks"] + s["mpc_ticks"])
    _hold_bounds("three-tier stand", [
        ("three_tier", s["three_tier"], "True", s["three_tier"]),
        ("upright", s["upright"], "True", s["upright"]),
        ("height_err", s["height_err"], "< 0.04", s["height_err"] < 0.04),
        ("final_est_err", s["final_est_err"], "< 0.03", s["final_est_err"] < 0.03),
        ("est_rate_used", s["est_rate_used"], f">= mpc_rate_used {s['mpc_rate_used']:.4g}",
         s["est_rate_used"] >= s["mpc_rate_used"]),
        ("est_updates", s["est_updates"], f"> {floor:g}", s["est_updates"] > floor)])


def _gate_async_stand(s):  # test_hardware_loop.py:462-475
    _hold_bounds("async_mpc stand", [
        ("async_mpc", s["async_mpc"], "True", s["async_mpc"]),
        ("upright", s["upright"], "True", s["upright"]),
        ("height_err", s["height_err"], "< 0.04", s["height_err"] < 0.04),
        ("final_est_err", s["final_est_err"], "< 0.03", s["final_est_err"] < 0.03),
        ("drift_speed_mps", s["drift_speed_mps"], "< 0.05", s["drift_speed_mps"] < 0.05)])


def _gate_pool(s):
    _check(s["upright"] and s["cmds_published"] > 0,
           f"hardware pool: upright {s['upright']}, {s['cmds_published']} published")


# test_threaded_loopback_walk_phase (test_hardware_loop.py:308-327): stand,
# walk at 0.3 m/s for 1.2 s, stand; servo at 250 Hz
HW_TWO_TIER_WALK = dict(duration_s=0.8, prime_s=0.5, walk_s=1.2, velx=0.3)


def phase_hw_threaded(device):
    """The threaded loop (RateLoop threads, seqlock buses, UDP, the sim peer;
    the tick and the peer's period replayed graphs), one run after another
    in a fresh process (`--worker hardware-threaded`, nothing else running:
    the clock judges these runs, and a long process's state, profilers
    included, slows a replay): the two-tier stand, the three-tier stand (estimator 250 Hz),
    the async_mpc stand and the two-tier walk held to the JAX tests' own
    bounds, the 50 Hz asked kept; the puller pool held to its mechanism and
    upright."""
    runs = [("two-tier stand", _gate_stand, dict(duration_s=1.0, prime_s=0.5)),
            ("three-tier stand (est 250 Hz)", _gate_three_tier_stand,
             dict(duration_s=1.0, prime_s=0.5, est_rate=250.0)),
            ("async_mpc stand", _gate_async_stand,
             dict(duration_s=1.5, prime_s=0.5, async_mpc=True)),
            ("pool stand (4 pullers)", _gate_pool,
             dict(duration_s=1.0, prime_s=0.5, async_pullers=4)),
            ("two-tier walk", _gate_walk, HW_TWO_TIER_WALK)]
    out, k1, k7, k9 = {}, 0, 0, [0, 0]
    for what, gate, kw in runs:
        s, n1, n7, n9 = _hw_threaded(device, what, gate, **kw)
        out[what] = {k: s[k] for k in _HW_PRINTED}
        k1, k7, k9 = k1 + n1, k7 + n7, [k9[0] + n9[0], k9[1] + n9[1]]
    # K2 and K8 launch as often as K1 in every run (_hw_threaded holds each)
    print(json.dumps({"threaded": out, "k1": k1, "k7": k7, "k2": k1, "k8": k1, "k9": k9}))


# The walks of tests/test_hardware_loop.py that it runs in fresh processes
# (tests/_hw_walk_worker.py): the three-tier walk with estimator and servo at
# 150 Hz, and the puller pool at 100 Hz asked.
HW_FRESH_WALKS = {
    "hardware-walk-three-tier": dict(duration_s=0.7, prime_s=0.6, walk_s=1.2, velx=0.3,
                                     est_rate=150.0, low_rate=150.0),
    "hardware-walk-pool": dict(duration_s=0.7, prime_s=0.6, walk_s=1.2, velx=0.3, mpc_rate=100.0,
                               est_rate=150.0, low_rate=150.0, async_pullers=4),
}
HW_THREE_TIER_RUNS = 4


def _worker_hw_walk(name):
    def run(device):
        s, k1, k7, _ = _hw_threaded(device, f"{name} (a fresh process)", None,
                                    **HW_FRESH_WALKS[name])
        print(json.dumps({"summary": {k: v for k, v in s.items()
                                      if isinstance(v, (bool, int, float))},
                          "k1": k1, "k7": k7}))
    return run


def _fresh(name):
    """A worker in a process of its own, nothing else running; the JSON it
    prints last (its launch counts are checked in the process)."""
    proc = subprocess.run([sys.executable, __file__, "--worker", name], capture_output=True,
                          text=True, timeout=300)
    sys.stdout.write(proc.stdout.rsplit("\n", 2)[0] + "\n")
    _check(proc.returncode == 0, f"{name}: exit {proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_hw_fresh_walks():
    """test_three_tier_walk_survival (test_hardware_loop.py:350-400): the
    three-tier walk in HW_THREE_TIER_RUNS fresh processes, one after the
    other: every run three-tier, walking, its estimator at 150 Hz or more
    and its KF error under 0.05 m, and each survivor walked more than 0.1 m
    (held). The JAX test also needs at least 3 of 4 upright: that count is
    printed beside its bound with each run's latency and overruns, not held
    (ROADMAP queue 3: the JAX package's own walk, in fresh processes on a
    CPU, falls about as often as the port's, most of its falls with tens of
    MPC overruns; a host that stalls the loop's threads fells walks of
    both). Then the pool walk at
    100 Hz asked (test_pool_pipeline_walk_100hz) in one more, held to its
    rate and its publishing (at least 90% of the ticks, less 10)."""
    runs = [_fresh("hardware-walk-three-tier") for _ in range(HW_THREE_TIER_RUNS)]
    sums = [r["summary"] for r in runs]
    survivors = [s for s in sums if s["upright"]]
    print(f"[hardware] three-tier walks: {len(survivors)} of {HW_THREE_TIER_RUNS} upright (the "
          f"JAX test's bound: >= 3; printed, not held: the JAX package's walk falls as often, "
          f"ROADMAP queue 3); final heights "
          f"{[round(s['final_height'], 4) for s in sums]}, command latency (tick_wall_ms) "
          f"{[round(s['tick_wall_ms'], 2) for s in sums]}, MPC / servo / estimator overruns "
          f"{[(s['mpc_overruns'], s['servo_overruns'], s['est_overruns']) for s in sums]}",
          flush=True)
    _hold_bounds(f"three-tier walks ({HW_THREE_TIER_RUNS} fresh processes)", [
        ("every run three-tier and walking", all(s["three_tier"] and s["walk_ticks"] > 0
                                                 for s in sums), "True",
         all(s["three_tier"] and s["walk_ticks"] > 0 for s in sums)),
        ("min est_rate_used", min(s["est_rate_used"] for s in sums), ">= 150",
         all(s["est_rate_used"] >= 150.0 for s in sums)),
        ("max final_est_err", max(s["final_est_err"] for s in sums), "< 0.05",
         all(s["final_est_err"] < 0.05 for s in sums)),
        ("survivors' min walk_distance_m",
         min((s["walk_distance_m"] for s in survivors), default=float("nan")), "> 0.1",
         all(s["walk_distance_m"] > 0.1 for s in survivors))])
    pool = _fresh("hardware-walk-pool")["summary"]
    floor = 0.9 * (pool["prime_ticks"] + 2 * pool["mpc_ticks"] + pool["walk_ticks"]) - 10
    _hold_bounds("pool walk at 100 Hz (a fresh process)", [
        ("mpc_rate_used", pool["mpc_rate_used"], "== 100.0", pool["mpc_rate_used"] == 100.0),
        ("cmds_published", pool["cmds_published"], f">= {floor:g}",
         pool["cmds_published"] >= floor)])
    return {"three_tier_walks": sums, "pool_walk_100hz": pool}


def _worker_hw_k7_shapes(device):
    """K7 at the hardware loop's shapes, B=1: the peer's servo period
    (n_sub = 32 over 4 ms) and the sync flows' tick (n_sub = 160 over
    20 ms), on the peer's inputs at the last MPC tick of a short stand flow
    (its state and its (12, 5) command, the gains as commanded), in f64 and
    f32 against the plain step on the CPU in f64, to phase 13's tolerances
    (K7_TOL). Where the f32 plain step itself leaves the f64 one beyond the
    f32 tolerance (a stick / slip flip), the f32 kernel is held to the f32
    plain step instead, as phase_k7_vs_plain does."""
    from quaternion_mpc_tpu_torch.control.torque import JointTargets
    from quaternion_mpc_tpu_torch.kernels import articulated as k7
    from quaternion_mpc_tpu_torch.sim import articulated as art
    from quaternion_mpc_tpu_torch.utils.tree import tree_leaves, tree_map

    kept = {}
    _hw_sync_flow(device, (6, 1, 3, [("prime", 10), ("stand", 10)]),
                  lambda k, label, tick_in, peer_in: kept.update(peer=peer_in))
    state, cmd = kept["peer"]
    cpu = torch.device("cpu")

    def step(dev, dtype, n_sub, dt, backend):
        cast = lambda tree: tree_map(
            lambda t: (t.to(dtype) if t.is_floating_point() else t).to(dev), tree)
        _, ap, _ = _hw_setup(dev, dtype)
        cm = cast(cmd).reshape(4, 3, 5)
        return art.step(cast(state), JointTargets(q=cm[..., 0], dq=cm[..., 1], tau=cm[..., 2]),
                        ap._replace(kp_joint=cm[..., 3], kd_joint=cm[..., 4]), dt, n_sub,
                        backend=backend)

    def err(got, want):
        return max((g.to(cpu, torch.float64) - w.double()).abs().max().item()
                   / max(1.0, w.double().abs().max().item())
                   for g, w in zip(tree_leaves(got), tree_leaves(want)))

    for n_sub, dt in HW_K7_SHAPES:
        plain = {dtype: step(cpu, dtype, n_sub, dt, "plain")
                 for dtype in (torch.float64, torch.float32)}
        flipped = err(plain[torch.float32], plain[torch.float64]) > K7_TOL[torch.float32]
        for dtype in (torch.float64, torch.float32):
            before = k7.articulated_step.launches
            got = step(device, dtype, n_sub, dt, None)
            torch.cuda.synchronize()
            _check(k7.articulated_step.launches == before + 1, "articulated_step did not launch")
            to32 = dtype == torch.float32 and flipped
            e = err(got, plain[torch.float32 if to32 else torch.float64])
            tag = f"articulated_step {str(dtype)[6:]} B=1 n_sub={n_sub} (the hardware loop's)"
            against = "f32 (its f32 plain step flips a stick / slip decision)" if to32 else "f64"
            line = (f"max|err|/scale {e:.3e} (tol {K7_TOL[dtype]}) against the plain step on "
                    f"the CPU in {against}")
            _check(e <= K7_TOL[dtype], f"{tag}: {line}")
            print(f"[K7] {tag} vs plain: {line}")


# Beside phase 14's sync flows: K7 held at the loop's own shapes, a process
# of its own. The threaded runs, which the clock judges, run alone.
HW_WORKERS = {"hardware-k7-shapes": _worker_hw_k7_shapes}


# The CLI as a user runs it, each command a process of its own: (argv, the
# JSON keys it must print; None: the loop's summary, which holds _HW_PRINTED).
HW_CLI_LOOP = (["run_hardware", "--duration", "1.0"], None)
HW_CLI_BENCH = (["bench_solver", "--batch", "4096"],
                {"batch", "horizon", "p50_step_ms", "solves_per_sec", "per_solve_ms", "mean_cost"})


def _start_cli(argv):
    return subprocess.Popen([sys.executable, "-m", "quaternion_mpc_tpu_torch.cli", *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=pathlib.Path(__file__).resolve().parent), time.perf_counter()


def _finish_cli(started, argv, keys, where):
    """Waits for a CLI process (it is killed if it outlives 300 s), checks
    its exit and its JSON keys, prints its JSON; returns it."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    _check(proc.returncode == 0, f"cli {argv[0]}: exit {proc.returncode}\n{err[-2000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    if keys is None:  # the loop's summary
        _check(set(_HW_PRINTED) <= set(res), f"cli run_hardware: keys {sorted(res)}")
    else:
        _check(set(res) == keys, f"cli {argv[0]}: keys {sorted(res)}")
    print(f"[cli] python -m quaternion_mpc_tpu_torch.cli {' '.join(argv)} ({where}; "
          f"{time.perf_counter() - t0:.1f} s from its start, the interpreter's included, to its "
          f"collection): {json.dumps(res)}")
    return res


def phase_hardware(device, smi):
    """Phase 14: the sync flows and the f64 check with HW_WORKERS and the
    CLI's loop beside them; then, with nothing beside it, the graphs against
    the eager calls, the timed tick, the threaded runs, the walks in fresh
    processes and the CLI's bench. Returns a dict for the kernels line."""
    t0 = time.perf_counter()
    workers = _start_workers(HW_WORKERS)
    loop_cli = _start_cli(HW_CLI_LOOP[0])
    _k10().launches = 0
    try:
        k1_stand, carry, tick6 = phase_hw_stand_flow(device)
        k1_walk, kept, peer_kept, tick8, consts = phase_hw_walk_flow(device)
        worst_f64 = phase_hw_card_vs_cpu(device, kept, tick8)
        # the hardware loop's tick runs its own stages, not the walking pre
        _check(_k10().launches == 0,
               f"hardware flows: K10 launched {_k10().launches} times")
    except BaseException:
        loop_cli[0].kill()
        loop_cli[0].wait()
        raise
    finally:
        _join_workers(workers)
    cli_loop = _finish_cli(loop_cli, *HW_CLI_LOOP, "beside the sync flows")
    print(f"[hardware] sync flows and card against CPU beside {len(HW_WORKERS)} worker and the "
          f"CLI's loop: {time.perf_counter() - t0:.1f} s")
    per_replay = phase_hw_graph_vs_eager(device, kept, peer_kept, tick8, consts)
    timing = phase_hw_tick_timing(device, carry, tick6, smi)
    threaded = _fresh("hardware-threaded")
    n_stand, n_walk = (sum(n for _, n in flow[3]) for flow in (HW_STAND, HW_WALK))
    _k2_count("hardware_sync_flows_1x3_2x3_B1", k1_stand[3] + k1_walk[3],
              k8=k1_stand[4] + k1_walk[4],
              k9=(k1_stand[5] + k1_walk[5], k1_stand[6] + k1_walk[6]), solves=n_stand + n_walk)
    _k2_count("hardware_threaded_loops_1x3_B1_graphed", threaded["k2"], k8=threaded["k8"],
              k9=tuple(threaded["k9"]))
    threaded, k1_thr, k7_thr = threaded["threaded"], threaded["k1"], threaded["k7"]
    walks = phase_hw_fresh_walks()
    cli_bench = _finish_cli(_start_cli(HW_CLI_BENCH[0]), *HW_CLI_BENCH, "alone")
    print(f"[hardware] phase wall {time.perf_counter() - t0:.1f} s")
    return dict(k1_per_tick={"hardware_tick_1x3_B1": k1_stand[0] / n_stand,
                             "hardware_walk_flow_tick_2x3_B1": k1_walk[0] / n_walk},
                k1_launches={"hardware_sync_flows_1x3_2x3_B1": k1_stand[0] + k1_walk[0],
                             "hardware_threaded_loops_1x3_B1_graphed": k1_thr},
                k7_launches={"hardware_peer_sync_flows_n_sub160": k1_stand[1] + k1_walk[1],
                             "hardware_peer_threaded_loops_graphed": k7_thr},
                graphs_launches_per_replay=per_replay,
                tick=timing, threaded=threaded, fresh_walks=walks, worst_f64=worst_f64,
                cli_p50_step_ms_B4096=cli_bench["p50_step_ms"],
                cli_run_hardware={k: cli_loop[k] for k in
                                  ("mpc_rate_used", "tick_wall_ms", "upright", "height_err")})


# ---------------------------------------------------------------------------
# Phase 15: the fleet over torch.distributed (`parallel/`), checkpoints and
# `cli run_fleet`
# ---------------------------------------------------------------------------

FLEET_B = 4096
FLEET_STEPS = 4  # an unbroken run; the resumed one is FLEET_STEPS // 2 twice
FLEET_K1_PER_TICK = {False: 10, True: 8}  # standing 2 x 5, walking 2 x 4 (the CLI's options)


def _fleet_start(device, walk):
    """`cli run_fleet`'s fleet at B=FLEET_B, f32, horizon 10, built as the
    CLI builds it (the same velocity draw, np.random.default_rng(1)); its
    step."""
    from quaternion_mpc_tpu_torch.control import quat_mpc
    from quaternion_mpc_tpu_torch.models import srb
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.utils import config as cfg
    from quaternion_mpc_tpu_torch.utils.tree import tile

    dtype = torch.float32
    wts = quat_mpc.weights_from_config(cfg.gazebo_go1_quat_mpc(), dtype=dtype, device=device)
    if walk:
        carry1, sp1 = rt.init_walking_scenario(wts, dtype=dtype, ctrl_wts=wts, device=device)
        joy1 = rt.neutral_joy(dtype, device)._replace(
            velx=torch.full((), walk, dtype=dtype, device=device))
        step = rt.make_fleet_walking_step(horizon=HORIZON, controller="quat")
    else:
        carry1, sp1 = rt.init_scenario(wts, srb.go1_params(dtype=dtype, device=device).foot_pos,
                                       dtype=dtype, ctrl_wts=wts, device=device)
        joy1 = rt.neutral_joy(dtype, device)
        step = rt.make_fleet_standing_step(horizon=HORIZON, controller="quat")
    carry, sp, joy = (tile(t, FLEET_B) for t in (carry1, sp1, joy1))
    vel = torch.as_tensor(0.05 * np.random.default_rng(1).standard_normal((FLEET_B, 3)),
                          dtype=dtype).to(device)
    return carry._replace(plant=carry.plant._replace(vel=vel)), sp, joy, step


def _fleet_run(step, carry, sp, joy, what, want_k1):
    """FLEET_STEPS ticks, each held to its K1 launches and as many of K2's
    and K8's; the carry, the last tick's metrics and the K1 launches."""
    from quaternion_mpc_tpu_torch.kernels import line_search as k2
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    rs.riccati_sweep.launches = k2.line_search.launches = _k8().launches = _k10().launches = 0
    _k11().launches = 0
    _zero_k9()
    for k in range(FLEET_STEPS):
        before = (rs.riccati_sweep.launches, k2.line_search.launches, _k8().launches)
        carry, metrics = step(carry, sp, joy)
        got = (rs.riccati_sweep.launches - before[0], k2.line_search.launches - before[1],
               _k8().launches - before[2])
        _check(got == (want_k1,) * 3,
               f"{what} tick {k}: (K1, K2, K8) launches {got}, expected {want_k1} each")
    torch.cuda.synchronize()
    # the walking fleet's ticks launch K10 once each (`cli run_fleet --walk`
    # runs this step), the standing fleet's never
    walking = hasattr(carry, "gait")
    _check(_k10().launches == (FLEET_STEPS if walking else 0),
           f"{what}: K10 launches {_k10().launches} in {FLEET_STEPS} ticks")
    _k10_count(f"run_fleet's step {what}", _k10().launches)
    # both fleets' posts are K11, once a tick
    _check(_k11().launches == FLEET_STEPS,
           f"{what}: K11 launches {_k11().launches} in {FLEET_STEPS} ticks")
    _k11_count(f"run_fleet's step {what}", _k11().launches)
    _k2_count("run_fleet_standing_2x5_walking_2x4_B4096", k2.line_search.launches,
              k8=_k8().launches, solves=FLEET_STEPS)
    return carry, metrics, rs.riccati_sweep.launches


def _same_carry(got, want, what):
    from quaternion_mpc_tpu_torch.utils.tree import tree_leaves

    g, w = tree_leaves(got), tree_leaves(want)
    _check(len(g) == len(w), f"{what}: {len(g)} leaves, {len(w)}")
    for i, (a, b) in enumerate(zip(g, w)):
        if not torch.equal(a.to(b.device), b):
            diff = float((a.to(b.device).double() - b.double()).abs().max())
            raise AssertionError(f"{what}: leaf {i} {tuple(b.shape)} differs by {diff:.3e}")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fleet_cli(argv, env=None):
    return subprocess.Popen([sys.executable, "-m", "quaternion_mpc_tpu_torch.cli", *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=pathlib.Path(__file__).resolve().parent), time.perf_counter()


FLEET_KEYS = {"devices", "batch", "steps", "wall_s", "solves_per_sec", "fleet_alive",
              "fleet_mean_cost", "resumed_at"}


def _hold_fleet_json(res, metrics, what, resumed_at=0):
    """The CLI's fleet totals are the sums of the unsharded step's
    per-scenario metrics, as the CLI rounds them."""
    alive = round(float(metrics.alive.sum()) / FLEET_B, 4)
    cost = round(float(metrics.mpc_cost.double().sum()) / FLEET_B, 5)
    _check(res["devices"] == 1 and res["batch"] == FLEET_B and res["resumed_at"] == resumed_at
           and res["fleet_alive"] == alive and abs(res["fleet_mean_cost"] - cost) <= 1e-5,
           f"cli {what}: {res} against the unsharded step's alive {alive}, mean cost {cost}")


def phase_fleet(device, smi):
    """Phase 15: `cli run_fleet` as processes at B=FLEET_B, f32, horizon 10
    (standing, 2 x 5; --walk 0.3, 2 x 4), each checkpointing its final
    carry, held against the unsharded fleet step driven here from the same
    start: the same carry bit for bit, the printed totals the sums of its
    metrics. The standing process runs in a one-rank NCCL group (torchrun's
    environment), as does, here, the fleet sharded over a one-rank group
    that `distributed.init` joins at a local address (its carry the
    unsharded one's; a profiled tick shows its all_reduce calls going
    through NCCL). A
    run of FLEET_STEPS // 2, checkpointed, then resumed for as many, ends
    on the unbroken run's carry bit for bit."""
    import tempfile

    from quaternion_mpc_tpu_torch.kernels import build as kbuild
    from quaternion_mpc_tpu_torch.parallel import distributed
    from quaternion_mpc_tpu_torch.parallel import mesh as mesh_mod
    from quaternion_mpc_tpu_torch.utils import checkpoint as ckpt

    t0 = time.perf_counter()
    half = FLEET_STEPS // 2
    base = ["run_fleet", "--batch", str(FLEET_B)]
    nccl_env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                    WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    with tempfile.TemporaryDirectory(dir=kbuild.BUILD_DIR) as tmp:  # an ignored directory
        tmp = pathlib.Path(tmp)
        procs = {
            "standing": _fleet_cli(base + ["--steps", str(FLEET_STEPS), "--checkpoint",
                                           str(tmp / "standing")], nccl_env),
            "half": _fleet_cli(base + ["--steps", str(half), "--checkpoint", str(tmp / "half")]),
            "walking": _fleet_cli(base + ["--steps", str(FLEET_STEPS), "--walk", "0.3",
                                          "--checkpoint", str(tmp / "walking")]),
        }
        try:
            refs = {}
            for walk in (0.0, 0.3):
                carry, sp, joy, step = _fleet_start(device, walk)
                refs[walk] = _fleet_run(step, carry, sp, joy, f"unsharded fleet walk={walk}",
                                        FLEET_K1_PER_TICK[walk > 0]) + (carry, sp, joy, step)
            # the same standing fleet over a one-rank NCCL group joined at a local address
            info = distributed.init(f"127.0.0.1:{_free_port()}", 1, 0, device=device)
            try:
                m = distributed.global_scenario_mesh(device)
                _check(info["process_count"] == 1 and m.group is not None and m.size == 1,
                       f"one-rank NCCL group: {info}, {m}")
                carry, sp, joy, step = refs[0.0][3:]
                sharded = mesh_mod.fleet_shard(step, m)
                shards = [mesh_mod.shard_batch(t, m) for t in (carry, sp, joy)]
                # the rank's part is a CUDA graph: this call captures it (its
                # warm-ups launch eagerly), so each tick counted is a replay
                sharded(*shards)
                got, totals, k1_nccl = _fleet_run(sharded, *shards, "fleet over NCCL",
                                                  FLEET_K1_PER_TICK[False])
                _same_carry(got, refs[0.0][0], "fleet over a one-rank NCCL group")
                for name, total in totals._asdict().items():
                    _check(torch.equal(total, getattr(refs[0.0][1], name).sum(0)),
                           f"NCCL all_reduce of {name}: {total} against the unsharded sum")
                from torch.autograd import DeviceType
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    sharded(*shards)
                    torch.cuda.synchronize()
                events = prof.events()
                calls = sum(e.name == "nccl:all_reduce" for e in events
                            if e.device_type == DeviceType.CPU)
                nccl = sum("nccl" in e.name.lower() for e in events
                           if e.device_type == DeviceType.CUDA)
                _check(calls == len(totals), f"a sharded tick traced {calls} nccl:all_reduce "
                                             f"calls for {len(totals)} metrics; its collective "
                                             f"events: {sorted({e.name for e in events if 'reduce' in e.name})}")
            finally:
                torch.distributed.destroy_process_group()
            results = {}
            for name, started in procs.items():
                results[name] = _finish_fleet_cli(started, name)
            procs["resumed"] = _fleet_cli(base + ["--steps", str(half), "--resume",
                                                  str(tmp / "half"), "--checkpoint",
                                                  str(tmp / "resumed")])
            results["resumed"] = _finish_fleet_cli(procs["resumed"], "resumed")
        finally:
            for proc, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for name, walk in (("standing", 0.0), ("walking", 0.3)):
            want = refs[walk][0]
            _same_carry(ckpt.restore(tmp / name, like=want), want,
                        f"cli run_fleet {name} against the unsharded step")
            _hold_fleet_json(results[name], refs[walk][1], name)
        _same_carry(ckpt.restore(tmp / "resumed", like=refs[0.0][0]),
                    ckpt.restore(tmp / "standing", like=refs[0.0][0]),
                    "a checkpointed and resumed run against the unbroken one")
        _check(results["resumed"]["resumed_at"] == half and ckpt.metadata(tmp / "resumed")
               == {"step": FLEET_STEPS, "batch": FLEET_B}, f"resumed run: {results['resumed']}")
    print(f"[fleet] cli run_fleet B={FLEET_B} f32 ({FLEET_STEPS} ticks): standing (in a one-rank "
          f"NCCL group) and --walk 0.3 end on the unsharded step's carry bit for bit, their totals "
          f"its sums; {half} + {half} ticks through a checkpoint end on the unbroken run's carry "
          f"bit for bit; in this process the fleet over a one-rank NCCL group joined at a local "
          f"address: the same carry, {calls} nccl:all_reduce calls and {nccl} NCCL kernels on the "
          f"card in a traced tick; K1 and K2 {FLEET_K1_PER_TICK[False]} / "
          f"{FLEET_K1_PER_TICK[True]} each a standing / walking tick; {time.perf_counter() - t0:.1f} s; {smi}")
    return dict(k1_launches={"run_fleet_unsharded_standing_2x5_B4096": refs[0.0][2],
                             "run_fleet_unsharded_walking_2x4_B4096": refs[0.3][2],
                             "run_fleet_nccl_one_rank_standing_2x5_B4096": k1_nccl},
                cli={name: {k: results[name][k] for k in ("wall_s", "solves_per_sec",
                                                          "fleet_alive", "fleet_mean_cost")}
                     for name in results})


def _finish_fleet_cli(started, what):
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    _check(proc.returncode == 0, f"cli run_fleet {what}: exit {proc.returncode}\n{err[-3000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    _check(set(res) == FLEET_KEYS, f"cli run_fleet {what}: keys {sorted(res)}")
    print(f"[cli] python -m quaternion_mpc_tpu_torch.cli run_fleet ({what}; beside the other "
          f"run_fleet processes and this one's checks; {time.perf_counter() - t0:.1f} s from its "
          f"start to its collection): {json.dumps(res)}")
    return res


# ---------------------------------------------------------------------------
# Phase 16: the entry points' CUDA graphs (`utils.graphs.Graphed`, at the
# call sites where the JAX package jits) against the eager calls
# ---------------------------------------------------------------------------

GRAPH_TIMED = 10   # timed calls a side, in turns: eager, graphed, graphed, eager
GRAPH_TICKS = 20   # chained ticks of a closed loop held graphed against eager
GRAPH_SHORT = 10   # the same for the slower or smaller loops
CONTROLLER_B = (1, 256, 4096, 16384)
ASSOC_SHAPES = (("controller N=10", 10, 2, 5, 8), ("controller N=20", 20, 2, 5, 8),
                ("hardware tick's solve N=6", 6, 1, 3, 12))


def _tensors(tree):
    from quaternion_mpc_tpu_torch.utils import graphs

    return graphs.tensors(tree)


def _elements_differ(got, want, what):
    """(elements that differ, elements in all) over every tensor of two
    outputs of one structure; NaN equals NaN (a runaway start's)."""
    g, w = _tensors(got), _tensors(want)
    _check(len(g) == len(w) and all(a.shape == b.shape and a.dtype == b.dtype
                                    for a, b in zip(g, w)),
           f"{what}: the graphed and eager outputs differ in structure")
    differ = 0
    for a, b in zip(g, w):
        ne = a != b
        if a.is_floating_point():
            ne &= ~(torch.isnan(a) & torch.isnan(b))
        differ += int(ne.sum())
    return differ, sum(b.numel() for b in w)


def _graph_turns(eager, graphed, calls=GRAPH_TIMED):
    """Seconds of each call of ``eager()`` and ``graphed()``, each ending in
    a synchronise, in turns (eager, graphed, graphed, eager) after one warm
    call of each."""
    eager()
    graphed()
    torch.cuda.synchronize()
    times = {eager: [], graphed: []}
    for fn in (eager, graphed, graphed, eager):
        for _ in range(calls // 2):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[fn].append(time.perf_counter() - t0)
    return times[eager], times[graphed]


def _counts():
    from quaternion_mpc_tpu_torch.utils import graphs

    return {c.__name__: c.launches for c in graphs.launch_counters()}


def _zero_counts():
    from quaternion_mpc_tpu_torch.utils import graphs

    for c in graphs.launch_counters():
        c.launches = 0


def _per_replay(al, ilqr, k1="riccati_sweep", k7=0, k10=0, k11=0):
    """A replay's kernel launches, one solve: al x ilqr of K1 (or K4's fused
    entry), K2 and K8; K9's rollout once and its pricing al + 1 times;
    ``k7`` of K7, ``k10`` of K10 and ``k11`` of K11."""
    n_iter = al * ilqr
    want = {k1: n_iter, "line_search": n_iter, "knot_expansions": n_iter, "rollout": 1,
            "price": al + 1}
    if k7:
        want["articulated_step"] = k7
    if k10:
        want["walking_pre"] = k10
    if k11:
        want["srb_post"] = k11
    return want


def _hold_graph(cap, what, want):
    _check(cap.per_replay == want, f"{what}: launches a replay {cap.per_replay}, expected {want}")


class _GraphRecord:
    """What phase 16 prints and returns of every graph: its path, the
    elements that differ from eager (of all), launches a replay, capture
    seconds, pool bytes, and for the timed paths p50 / min / max of both
    sides and a traced replay's and eager call's device ops and busy ms."""

    def __init__(self):
        self.paths = {}
        self.k1 = {}
        self.k7 = {}
        self.cli = {}

    def add(self, path, cap, differ, **more):
        _check(differ[0] == 0, f"graphed {path}: {differ[0]} of {differ[1]} elements differ "
                               f"from the eager run")
        self.paths[path] = dict(elements_differ=list(differ), per_replay=cap.per_replay,
                                capture_s=cap.capture_s, pool_bytes=cap.pool_bytes, **more)
        print(f"[graphs] {path}: 0 of {differ[1]:,} elements differ from eager; launches a "
              f"replay {cap.per_replay}; warm-up and capture {cap.capture_s:.2f} s, pool "
              f"{cap.pool_bytes / 2**20:.1f} MiB")

    def count(self, path, k2_instantiation="quat_srb_midpoint"):
        """The kernels' launches of the replays just run (counted from 0),
        into the kernels line under ``path``."""
        c = _counts()
        self.k1[path] = c["riccati_sweep"]
        if c["articulated_step"]:
            self.k7[path] = c["articulated_step"]
        if c["line_search"]:
            _k2_count(path, c["line_search"], k2_instantiation, k8=c["knot_expansions"],
                      k9=(c["rollout"], c["price"]))
        _k10_count(f"graphed {path}", c["walking_pre"])
        _k11_count(f"graphed {path}", c["srb_post"])

    def timed(self, path, eager, graphed, traced_k, calls=GRAPH_TIMED):
        """p50 / min / max of eager and graphed calls in turns, and a traced
        call of each: device ops and busy ms (``traced_k``: the K1, K7, K2,
        K8 and K9 (rollout, pricing) kernels a call launches)."""
        e, g = _graph_turns(eager, graphed, calls)
        rec = dict(eager_ms=_ms3(e), graphed_ms=_ms3(g))
        for side, fn, p50 in (("eager", eager, rec["eager_ms"][0]),
                              ("graphed", graphed, rec["graphed_ms"][0])):
            try:
                t = _profile_kernels(fn, f"{path} {side}", *traced_k)
                rec[f"{side}_trace"] = dict(device_ops=t["device_ops"],
                                            device_busy_ms=t["device_busy_ms"],
                                            busy_share_of_p50=t["device_busy_ms"] / p50)
            except RuntimeError as err:  # a record, not a check: the tracer may be unavailable
                rec[f"{side}_trace"] = f"not measured: {err}"
        self.paths[path].update(rec)
        tr = {s: rec[f"{s}_trace"] for s in ("eager", "graphed")}
        ops = "; ".join(f"{s} {t['device_ops']} device ops, busy {t['device_busy_ms']:.2f} ms "
                        f"({100 * t['busy_share_of_p50']:.1f}% of the p50)"
                        if isinstance(t, dict) else f"{s} trace {t}" for s, t in tr.items())
        print(f"[graphs] {path}: p50 / min / max eager {rec['eager_ms'][0]:.2f} / "
              f"{rec['eager_ms'][1]:.2f} / {rec['eager_ms'][2]:.2f} ms, graphed "
              f"{rec['graphed_ms'][0]:.3f} / {rec['graphed_ms'][1]:.3f} / "
              f"{rec['graphed_ms'][2]:.3f} ms ({len(e)} of each, in turns); {ops}")


def _graph_chain(step, carry, args, ticks):
    """``ticks`` chained calls of ``step(carry, *args)``; every tick's
    outputs."""
    outs = []
    for _ in range(ticks):
        carry, *out = step(carry, *args)
        outs.append((carry, *out))
    return outs


def _hold_chain(rec, path, fn, carry, args, ticks, want_per_replay, generators=(),
                reseed=None, k2_instantiation="quat_srb_midpoint"):
    """``ticks`` chained ticks of ``fn`` as `Graphed(chain=True)` against as
    many eager ticks from the same carry, every tick's state and outputs
    compared (the eager ones cloned as they come: the graph's state is its
    own buffer). ``reseed()``, where given, puts the generators back before
    each side. Returns the graph."""
    from quaternion_mpc_tpu_torch.utils.graphs import Graphed

    g = Graphed(fn, chain=True, generators=generators)
    cap = g.captured(carry, *args)
    _hold_graph(cap, path, want_per_replay)
    if reseed:
        reseed()
    eager = [tuple(_clone_tree(o) for o in out) for out in _graph_chain(fn, carry, args, ticks)]
    if reseed:
        reseed()
    _zero_counts()
    graphed = []
    c = carry
    for _ in range(ticks):
        c, *out = g(c, *args)
        graphed.append((_clone_tree(c), *out))
    torch.cuda.synchronize()
    rec.count(path, k2_instantiation)
    rec.add(path, cap, _elements_differ(graphed, eager, path), ticks=ticks)
    return g


def _clone_tree(tree):
    from quaternion_mpc_tpu_torch.utils.graphs import clone_tree

    return clone_tree(tree)


def _hold_call(rec, path, fn, inputs, want_per_replay, k2_instantiation="quat_srb_midpoint"):
    """``fn`` as `Graphed` against the eager call on each of ``inputs`` (a
    list of argument tuples: the capture's, then others the replay copies
    in). Returns the graph."""
    from quaternion_mpc_tpu_torch.utils.graphs import Graphed

    g = Graphed(fn)
    cap = g.captured(*inputs[0])
    _hold_graph(cap, path, want_per_replay)
    eager = [fn(*args) for args in inputs]
    _zero_counts()
    graphed = [g(*args) for args in inputs]
    torch.cuda.synchronize()
    rec.count(path, k2_instantiation)
    rec.add(path, cap, _elements_differ(graphed, eager, path), calls=len(inputs))
    return g


def _time_solve_scenario(rec, device, rounds=3):
    """`scenarios.solve_scenario("falling_cat")` in f32, one call timed each
    way, in turns: as the parent tree ran it (eager: `Graphed` taken out of
    the module for the call), its first call (the GRAPH_WARMUP warm-ups, the
    capture and one replay) and a later call with the same arguments (a
    replay of the graph it keeps). Leaves no graph kept."""
    from quaternion_mpc_tpu_torch import scenarios

    def call():
        scenarios.solve_scenario("falling_cat", dtype=torch.float32, device=device)
        torch.cuda.synchronize()

    def eager():
        kept = scenarios.Graphed
        scenarios.Graphed = lambda fn, **_: fn
        scenarios._SOLVES.clear()
        try:
            call()
        finally:
            scenarios.Graphed = kept
            scenarios._SOLVES.clear()

    def first():
        scenarios._SOLVES.clear()
        call()

    times = {eager: [], first: [], call: []}
    eager()  # builds whatever this shape has not built yet
    try:
        for order in ((eager, first, call), (call, first, eager)) * rounds:
            for fn in order:
                t0 = time.perf_counter()
                fn()
                times[fn].append(time.perf_counter() - t0)
    finally:
        scenarios._SOLVES.clear()
    got = {k: _ms3(times[f]) for k, f in (("eager_parent_ms", eager), ("first_call_ms", first),
                                          ("later_call_ms", call))}
    rec.paths["solve_scenario falling_cat, one call"] = got
    print("[graphs] solve_scenario falling_cat f32, one call, p50 / min / max: "
          + "; ".join(f"{k[:-3].replace('_', ' ')} {v[0]:.1f} / {v[1]:.1f} / {v[2]:.1f} ms"
                      for k, v in got.items())
          + f" ({2 * rounds} of each, in turns)")


# the CLI's commands run here, each with the kernels' counts set to 0 just
# before: (argv, K1 or K4 launches a call of the graphed function, calls of
# it the command makes: the capture's GRAPH_WARMUP warm-ups are added)
GRAPH_CLI_STEPS = 20
# (argv, the AL iterations and the K1 launches of a solve, the graphed calls)
GRAPH_CLI = (
    (["bench_solver", "--batch", "4096", "--iters", "10"], 2, 10, 1 + 10),
    (["run_standing", "--batch", "4096", "--steps", str(GRAPH_CLI_STEPS), "--push", "20",
      "--push-at", "5", "--push-ticks", "5"], 2, 10, 2 * GRAPH_CLI_STEPS),
    (["run_trot", "--batch", "4096", "--steps", str(GRAPH_CLI_STEPS)], 2, 8,
     2 * GRAPH_CLI_STEPS),
    (["run_actuated", "--batch", "64", "--steps", str(GRAPH_CLI_STEPS)], 2, 8,
     2 * GRAPH_CLI_STEPS),
    (["run_actuated", "--batch", "64", "--steps", str(GRAPH_CLI_STEPS), "--kf_type", "1"], 2, 8,
     2 * GRAPH_CLI_STEPS),
    (["run_scenario", "--name", "falling_cat"], 3, 75, 1),
    (["run_scenario", "--name", "falling_cat", "--closed_loop", "--steps", "10"], 2, 16, 10),
)


def _graph_cli(rec):
    """The CLI's commands in this process (`cli.main`), each counted from 0:
    its launches are those of its graphed calls plus the capture's
    GRAPH_WARMUP eager warm-ups, which an eager command would not run: the
    command went through its graph. Prints each command's JSON."""
    import contextlib
    import io

    from quaternion_mpc_tpu_torch import cli
    from quaternion_mpc_tpu_torch.utils.graphs import GRAPH_WARMUP

    for argv, al, per_call, calls in GRAPH_CLI:
        _zero_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            _check(cli.main(argv) == 0, f"cli {' '.join(argv)}: non-zero exit")
        torch.cuda.synchronize()
        c = _counts()
        k1 = c["riccati_sweep"] + c["assoc_backward"]
        solves = calls + GRAPH_WARMUP
        want = per_call * solves
        # `run_trot` (the walking fleet) launches K10 once a tick, the others never;
        # `run_standing` and `run_trot` (the SRB fleets) K11 once a tick
        k10 = solves if argv[0] == "run_trot" else 0
        k11 = solves if argv[0] in ("run_trot", "run_standing") else 0
        _check(c["walking_pre"] == k10 and c["srb_post"] == k11,
               f"cli {' '.join(argv)}: (K10, K11) launches {(c['walking_pre'], c['srb_post'])}, "
               f"expected {(k10, k11)}")
        _k10_count(f"cli {' '.join(argv)} in this process", c["walking_pre"])
        _k11_count(f"cli {' '.join(argv)} in this process", c["srb_post"])
        _check(k1 == want and c["line_search"] == c["knot_expansions"] == want
               and (c["rollout"], c["price"]) == (solves, (al + 1) * solves),
               f"cli {' '.join(argv)}: launches {c}, expected {want} of K1, K2 and K8 and "
               f"{solves} / {(al + 1) * solves} of K9's rollout / pricing ({calls} graphed "
               f"calls of {per_call} and {GRAPH_WARMUP} warm-ups)")
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        rec.cli[" ".join(argv)] = res
        print(f"[graphs] cli {' '.join(argv)} in this process: K1, K2 and K8 {want} each "
              f"({calls} x {per_call} replayed, {GRAPH_WARMUP} x {per_call} in the capture's "
              f"warm-ups); {json.dumps(res)}")


def _no_sync_call(fn, what):
    """fn() with every synchronising CUDA call an error (a capture would
    fail on one)."""
    fn()
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    print(f"[graphs] {what} under set_sync_debug_mode('error'): no synchronising call")


def phase_graphs(device, smi):
    """Phase 16: every entry point that the JAX package jits, as the port
    replays it on the card (`utils.graphs.Graphed`), held against the eager
    call of the same library function on the same inputs: every output's
    elements compared (0 may differ), each graph's kernel launches a replay
    (al x ilqr of K1 or K4's fused entry, K2 and K8; K7 once an actuated
    tick), its warm-up and capture seconds and its pool's bytes:

    a. `cli bench_solver`'s controller (`make_fleet_controller`, 2 x 5, 8
       alphas) at B in CONTROLLER_B in f32 and at B=256 in f64, a second
       set of inputs replayed as well; the convex controller (1 x 5) at
       B=4096;
    b. `cli _run_loop`'s tick, chained: the CLI's standing fleet at B=4096
       with a push window (the wrench an input of every tick), the walking
       RTI fleet at B=4096, the actuated fleet and its estimated step
       (BasicKF) at B=64; the estimated fleet with its noise from a CUDA
       generator registered with the graph, ten replays against ten eager
       ticks from the same generator state;
    c. `cli viz_forces`'s actuated step, one robot;
    d. `parallel.distributed.scaling_report_fleet` at one rank (`cli
       run_fleet`'s graphed step is held in phase 15, its processes' carries
       against the eager unsharded step);
    e. `scenarios.solve_scenario`'s solve (falling_cat at its own size),
       the falling_cat fleet (B=4096, N=40, 3 x 25) and
       `scenarios.run_closed_loop`'s receding tick, chained; one
       `solve_scenario` call timed eager (as the parent tree ran it), as its
       first call and as a later one (`_time_solve_scenario`).

    The controller's step and `make_solver`'s solve run once under
    `set_sync_debug_mode("error")` first. The CLI's commands (`GRAPH_CLI`)
    run in this process, each launching exactly its graphed calls' kernels
    and the capture's warm-ups'. Timed, eager and graphed in turns
    (p50 / min / max, a traced call of each: device ops, busy ms and its
    share of the p50): the fleet step at B=4096, the walking RTI tick, the
    convex step and the falling_cat 3 x 25 solve; then "assoc" against
    "sweep" replays at B=1 (ASSOC_SHAPES), in turns. Returns a dict for the
    kernels line."""
    from quaternion_mpc_tpu_torch import examples, scenarios
    from quaternion_mpc_tpu_torch.control import convex_mpc, quat_mpc
    from quaternion_mpc_tpu_torch.parallel import distributed
    from quaternion_mpc_tpu_torch.runtime import step as rt
    from quaternion_mpc_tpu_torch.sim.plant import ExtWrench
    from quaternion_mpc_tpu_torch.solver import al_ilqr
    from quaternion_mpc_tpu_torch.solver.problem import SolverOptions
    from quaternion_mpc_tpu_torch.utils.graphs import Graphed
    from quaternion_mpc_tpu_torch.utils.tree import tile

    t0 = time.perf_counter()
    rec = _GraphRecord()
    f32, f64 = torch.float32, torch.float64

    # a. the controller
    opts = SolverOptions(al_iterations=2, ilqr_iterations=5, max_linesearch=8)
    ctrl = quat_mpc.make_fleet_controller(HORIZON, opts)
    sync_in = examples.standing_batch(CONTROLLER_B[1], HORIZON, f32, device)
    _no_sync_call(lambda: ctrl(*sync_in), f"the fleet controller's step, B={CONTROLLER_B[1]}")
    fleet_graph = None
    for dtype, b in [(f32, b) for b in CONTROLLER_B] + [(f64, CONTROLLER_B[1])]:
        inputs = [examples.standing_batch(b, HORIZON, dtype, device, seed=s) for s in (0, 1)]
        g = _hold_call(rec, f"controller 2x5 {str(dtype)[6:]} B={b}", ctrl, inputs,
                       _per_replay(2, 5, "assoc_backward" if b == 1 else "riccati_sweep"))
        if dtype == f32 and b == CLOSED_LOOP_B:
            fleet_graph, fleet_inputs = g, inputs[0]
    rec.timed(f"controller 2x5 float32 B={CLOSED_LOOP_B}", lambda: ctrl(*fleet_inputs),
              lambda: fleet_graph(*fleet_inputs), (10, 0, 10, 10, (1, 3)))
    copts = SolverOptions(al_iterations=1, ilqr_iterations=5, max_linesearch=8)
    cctrl = convex_mpc.make_fleet_controller(HORIZON, copts)
    cin = examples.standing_batch(CLOSED_LOOP_B, HORIZON, f32, device, controller="convex")
    convex = f"convex controller 1x5 float32 B={CLOSED_LOOP_B}"
    cg = _hold_call(rec, convex, cctrl, [cin], _per_replay(1, 5),
                    k2_instantiation="euler_srb_midpoint")
    fz = cg(*cin)[0][..., 2].sum(-1).mean().item()
    rec.paths[convex]["mean_sum_fz_N"] = fz
    rec.timed(convex, lambda: cctrl(*cin), lambda: cg(*cin), (5, 0, 5, 5, (1, 2)))

    # b, c. the closed loops' ticks
    sopts = SolverOptions(al_iterations=2, ilqr_iterations=5)
    stand = rt.make_fleet_standing_step(HORIZON, sopts)
    carry, sp, joy = examples.standing_fleet(CLOSED_LOOP_B, f32, device)
    f = torch.tensor([0.0, 20.0, 0.0], dtype=f32, device=device)
    push = tile(ExtWrench(f, torch.linalg.cross(
        torch.tensor([0.0, 0.0, 0.1], dtype=f32, device=device), f)), CLOSED_LOOP_B)
    _hold_chain(rec, f"standing fleet 2x5 B={CLOSED_LOOP_B}, pushed 20 N", stand,
                carry, (sp, joy, push), GRAPH_SHORT, _per_replay(2, 5, k11=1))
    walk = rt.make_fleet_walking_step(HORIZON, _rti_opts(), warm_start=True)
    carry, sp, joy = examples.walking_batch(CLOSED_LOOP_B, HORIZON, f32, device, velx=0.3)
    wg = _hold_chain(rec, f"walking RTI fleet 1x3 B={CLOSED_LOOP_B}", walk,
                     carry, (sp, joy), GRAPH_TICKS, _per_replay(1, 3, k10=1, k11=1))
    state = {"eager": carry, "graphed": carry}

    def tick(side, fn):
        def run():
            state[side], _ = fn(state[side], sp, joy)
        return run

    rec.timed(f"walking RTI fleet 1x3 B={CLOSED_LOOP_B}", tick("eager", walk),
              tick("graphed", wg), (3, 0, 3, 3, (1, 2)))
    act = rt.make_actuated_walking_step(HORIZON, _act_opts(), n_sub=ACT_N_SUB)
    carry, sp, joy = examples.actuated_batch(ACT_B, f32, device)
    _hold_chain(rec, f"actuated fleet 2x4 B={ACT_B}", act, carry, (sp, joy), GRAPH_SHORT,
                _per_replay(2, 4, k7=1))
    est_act = rt.make_estimated_actuated_step(HORIZON, _act_opts(), kf_type=1, n_sub=ACT_N_SUB)
    carry, sp, joy = examples.actuated_batch(ACT_B, f32, device, kf_type=1)
    _hold_chain(rec, f"estimated actuated fleet (BasicKF) 2x4 B={ACT_B}", est_act,
                carry, (sp, joy), GRAPH_SHORT, _per_replay(2, 4, k7=1))
    one = rt.make_actuated_walking_step(HORIZON)
    carry, sp = rt.init_actuated_scenario(
        quat_mpc.weights_from_config(_go1_cfg(), dtype=f32, device=device), dtype=f32,
        device=device)
    joy = rt.neutral_joy(f32, device)._replace(velx=torch.full((), 0.4, dtype=f32, device=device))
    _hold_chain(rec, "viz_forces actuated step, one robot", one, carry, (sp, joy), 5,
                _per_replay(2, 4, k7=1))
    gen = torch.Generator(device=device).manual_seed(3)
    est = rt.make_fleet_estimated_step(HORIZON, _est_opts(), generator=gen, **EST_BENCH_STDS)
    carry, sp, joy = examples.estimated_batch(CLOSED_LOOP_B, HORIZON, f32, device)
    seeded = gen.get_state()
    _hold_chain(rec, f"estimated fleet 2x4 B={CLOSED_LOOP_B}, noise from a registered generator",
                est, carry, (sp, joy), GRAPH_SHORT, _per_replay(2, 4, k10=1, k11=1),
                generators=(gen,), reseed=lambda: gen.set_state(seeded))

    # d. the fleet over ranks (one here)
    report = distributed.scaling_report_fleet(
        rt.make_fleet_standing_step(HORIZON, sopts),
        lambda b: examples.standing_fleet(b, f32, device), (1,), CLOSED_LOOP_B, iters=5,
        device=device)
    print(f"[graphs] scaling_report_fleet at one rank, B={CLOSED_LOOP_B}, the rank's step "
          f"graphed: {report[1]['step_s'] * 1e3:.2f} ms a step")
    rec.paths["scaling_report_fleet one rank"] = {"step_ms": report[1]["step_s"] * 1e3}

    # e. the single-problem path
    spec, prob, sc_opts = scenarios.SCENARIOS["falling_cat"](dtype=f32, device=device)
    solver = al_ilqr.make_solver(spec, sc_opts)
    _no_sync_call(lambda: solver(prob), "make_solver's falling_cat solve")
    _hold_call(rec, "solve_scenario falling_cat", solver, [(prob,)],
               _per_replay(sc_opts.al_iterations, sc_opts.ilqr_iterations),
               k2_instantiation="attitude_midpoint")
    spec, prob, cat_opts = examples.falling_cat_fleet(CAT_FLEET_B, f32, device, seed=0)
    cat = al_ilqr.make_solver(spec, cat_opts)
    n_cat = cat_opts.al_iterations * cat_opts.ilqr_iterations
    catg = _hold_call(rec, f"falling_cat fleet 3x25 B={CAT_FLEET_B}", cat, [(prob,)],
                      _per_replay(cat_opts.al_iterations, cat_opts.ilqr_iterations),
                      k2_instantiation="attitude_midpoint")
    rec.timed(f"falling_cat fleet 3x25 B={CAT_FLEET_B}", lambda: cat(prob), lambda: catg(prob),
              (n_cat, 0, n_cat, n_cat, (1, cat_opts.al_iterations + 1)), calls=6)
    step, carry = scenarios.make_receding_step("falling_cat", dtype=f32, device=device)
    _hold_chain(rec, "run_closed_loop falling_cat receding tick", step, carry, (),
                GRAPH_SHORT, _per_replay(2, 8), k2_instantiation="attitude_midpoint")

    _time_solve_scenario(rec, device)

    _graph_cli(rec)

    # "assoc" against "sweep" at B=1, replayed
    assoc = {}
    for label, n, al, ilqr, alphas in ASSOC_SHAPES:
        o = SolverOptions(al_iterations=al, ilqr_iterations=ilqr, max_linesearch=alphas)
        inputs = examples.standing_batch(1, n, f32, device)
        sides = {}
        for backend in ("assoc", "sweep"):
            c = quat_mpc.make_fleet_controller(n, o, backend=backend)
            g = Graphed(c)
            cap = g.captured(*inputs)
            _hold_graph(cap, f"{label} {backend}", _per_replay(
                al, ilqr, "assoc_backward" if backend == "assoc" else "riccati_sweep"))
            _check(_elements_differ(g(*inputs), c(*inputs), label)[0] == 0,
                   f"{label} {backend}: graphed differs from eager")
            sides[backend] = lambda g=g: g(*inputs)
        a, s = _graph_turns(sides["assoc"], sides["sweep"], calls=20)
        assoc[label] = {"assoc_ms": _ms3(a), "sweep_ms": _ms3(s)}
        print(f"[graphs] B=1 {label}, {al}x{ilqr}, {alphas} alphas, replayed: assoc p50 / min / "
              f"max {_ms3(a)[0]:.3f} / {_ms3(a)[1]:.3f} / {_ms3(a)[2]:.3f} ms, sweep "
              f"{_ms3(s)[0]:.3f} / {_ms3(s)[1]:.3f} / {_ms3(s)[2]:.3f} ms (20 each, in turns)")
    print(f"[graphs] phase wall {time.perf_counter() - t0:.1f} s; {smi}")
    return dict(paths=rec.paths, assoc_vs_sweep_B1=assoc, k1_launches=rec.k1,
                k7_launches=rec.k7, cli=rec.cli)


def _go1_cfg():
    from quaternion_mpc_tpu_torch.utils import config as cfg

    return cfg.gazebo_go1_quat_mpc()


def phase_k7_kernels_only(device, baseline):
    """--kernels-only: K7 against the plain step, timed, and compared across
    block sizes, with a baseline source and by phase, on the mixed fleet's
    starting states (no trot) with the same perturbations."""
    states, _ = _k7_states(device, 0)
    phase_k7_vs_plain(device, states)
    phase_k7_timing(device, states)
    phase_k7_designs(states, baseline)



# The stack frame K8's Euler SRB instantiations may keep, in bytes: the
# accurate sine's and cosine's slow path (an argument beyond ~1e5 radians,
# which a yaw never reaches) reduces it through a small local array, as in
# torch.sin and torch.cos, whose bits the instantiations keep; no other
# instantiation keeps one.
K8_STACK = {"euler_srb_midpoint": 40, "euler_srb_euler": 40}


# K4's four kernels as ptxas reports them: (entry, type) ->
# registers, no stack, no spill. They share csrc/warp_tile.cuh with K1, and
# K4's code must not move with K1's.
K4_PTXAS = {("assoc_backward", "d"): 174, ("assoc_backward", "f"): 91,
            ("assoc_scan", "d"): 104, ("assoc_scan", "f"): 72}
# K1's 12 x 12 instantiations' registers as `knot` gives them (no stack,
# no spill): (lux, type) -> registers.
K1_PTXAS_12X12 = {(False, "f"): 109, (False, "d"): 232, (True, "f"): 109, (True, "d"): 234}


def _k1_kernel(name):
    """(ne, nu, lux, "f" or "d") of a K1 kernel's mangled name."""
    m = re.search(r"ShapeILi(\d+)ELi(\d+)ELb([01])E+([fd])", name)
    return int(m[1]), int(m[2]), m[3] == "1", m[4]


def _k1_tag(ne, nu, lux=False):
    return f"{ne}x{nu}{' lux' if lux else ''}"


def _print_ptxas(kbuild, rs, k4, libs):
    """What ptxas reported of each kernel; K1 at every instantiation, and K4
    in f32, must keep their working sets out of local memory (K4 in f64 is
    reported), and K4's four kernels and K1's 12 x 12 instantiations must be
    what they were (`K4_PTXAS`, `K1_PTXAS_12X12`); K7 must not
    spill in f32 or f64, nor K2's 52 kernels (f32 and f64, one or two lanes an
    alpha: the quaternion SRB and the Euler SRB under the midpoint rule and
    forward Euler at one to four feet, the attitude model), nor K8's 26 (f32
    and f64: the quaternion SRB, the Euler SRB under the midpoint rule and
    forward Euler at one to four feet, the attitude model), which keep no
    stack either but for the Euler SRB's sine and cosine (`K8_STACK`), nor
    K9's 52 (its rollout and pricing at K2's 13 models, f32 and f64)."""
    for lib in libs[1:]:
        for k in kbuild.ptxas_report(lib):
            print(f"[build] ptxas {lib.name.rsplit('_', 1)[0]} {k['name'][-40:]}: {k['registers']} "
                  f"registers, {k['stack']} bytes stack, spill {k['stores']} / {k['loads']} bytes")
    k1 = kbuild.ptxas_report(libs[0])
    for k in k1:
        ne, nu, lux, t = _k1_kernel(k["name"])
        print(f"[build] ptxas riccati_sweep {_k1_tag(ne, nu, lux)} "
              f"{'float32' if t == 'f' else 'float64'}: {k['registers']} registers, {k['stack']} "
              f"bytes stack, spill {k['stores']} / {k['loads']} bytes, dynamic shared memory "
              f"{rs.shared_bytes(torch.float32 if t == 'f' else torch.float64, lux, ne, nu)} bytes "
              f"a block")
    # f32 and f64 at each instantiation
    _check(sorted(_k1_kernel(k["name"]) for k in k1)
           == sorted((ne, nu, lux, t) for ne, nu, lux in rs.INSTANTIATIONS for t in "fd")
           and all(k["stack"] == k["stores"] == k["loads"] == 0 for k in k1),
           f"K1 spills, keeps a stack, or ptxas reported other kernels than its "
           f"{2 * len(rs.INSTANTIATIONS)}: {k1}")
    twelve = {(lux, t): k["registers"] for k in k1
              for ne, nu, lux, t in [_k1_kernel(k["name"])] if (ne, nu) == (12, 12)}
    _check(twelve == K1_PTXAS_12X12,
           f"K1's 12 x 12 instantiations' registers {twelve}, expected {K1_PTXAS_12X12}")
    k4_report = kbuild.ptxas_report(libs[1])
    k4_lines = {(m[1], m[2]): k["registers"] for k in k4_report
                for m in [re.search(r"(assoc_backward|assoc_scan)_kernelI([fd])", k["name"])]
                if k["stack"] == k["stores"] == k["loads"] == 0}
    _check(len(k4_report) == 4 and k4_lines == K4_PTXAS,
           f"K4's ptxas lines moved: {k4_report}, expected {K4_PTXAS} registers, no stack, "
           f"no spill")
    k7_report = kbuild.ptxas_report(libs[2])
    _check(len(k7_report) == 2 and all(k["stores"] == k["loads"] == 0 for k in k7_report),
           f"K7 spills (f32 or f64) or ptxas reported other kernels than its two: {k7_report}")
    k2_report = kbuild.ptxas_report(libs[3])
    _check(len(k2_report) == 52 and all(k["stores"] == k["loads"] == 0 for k in k2_report),
           f"K2 spills or ptxas reported other kernels than its 52: {k2_report}")
    k8_report = kbuild.ptxas_report(libs[4])
    stack = lambda k: K8_STACK.get(_k8_kernel(k["name"])[0], 0)
    _check(len(k8_report) == 26
           and all(k["stores"] == k["loads"] == 0 and k["stack"] <= stack(k) for k in k8_report),
           f"K8 spills (f32 or f64), keeps a stack, or ptxas reported other kernels than its 26: "
           f"{k8_report}")
    k9_report = kbuild.ptxas_report(libs[5])
    _check(len(k9_report) == 52 and all(k["stores"] == k["loads"] == 0 for k in k9_report),
           f"K9 spills or ptxas reported other kernels than its 52: {k9_report}")


def main(argv) -> int:
    t_start = time.perf_counter()
    hardware_only = argv == ["--hardware-only"]
    graphs_only = argv == ["--graphs-only"]
    baselines = dict(zip(argv[1::2], argv[2::2]))
    kernels_only = (argv[:1] == ["--kernels-only"] and len(argv) % 2 == 1
                    and set(baselines) <= {"--k7-baseline", "--k2-baseline", "--k8-baseline",
                                           "--k1-baseline", "--k9-baseline", "--k10-baseline",
                                           "--k11-baseline"}
                    and len(baselines) == len(argv) // 2)
    workers = {**WORKERS, **ACT_WORKERS, **HW_WORKERS, "hardware-threaded": phase_hw_threaded,
               "hardware-peer-profile": _worker_hw_peer_profile,
               **{name: _worker_hw_walk(name) for name in HW_FRESH_WALKS}}
    worker = argv[1] if len(argv) == 2 and argv[0] == "--worker" and argv[1] in workers else None
    if argv and not (kernels_only or worker or hardware_only or graphs_only):
        print("usage: chip_smoke.py [--kernels-only [--k1-baseline SOURCE] [--k7-baseline SOURCE] "
              "[--k2-baseline SOURCE] [--k9-baseline SOURCE] [--k10-baseline SOURCE] "
              "[--k11-baseline SOURCE[,SOURCE...]] "
              "[--k8-baseline SOURCE[,SOURCE...]] "
              "| --hardware-only | --graphs-only | "
              "--worker "
              f"{{{','.join(workers)}}}]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the GPU only",
              file=sys.stderr)
        return 1

    import quaternion_mpc_tpu_torch  # noqa: F401  (sets the full-f32 matmul flags)
    from quaternion_mpc_tpu_torch.kernels import riccati_sweep as rs

    # 1. device
    device = torch.device("cuda:0")
    if worker:  # one quality run of phase 11 or 13, beside the main process; the kernels are built
        workers[worker](device)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    _check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul must be off")
    print(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    # 2. build: one nvcc per source, all started together
    from quaternion_mpc_tpu_torch.kernels import assoc_scan as k4
    from quaternion_mpc_tpu_torch.kernels import build as kbuild

    from quaternion_mpc_tpu_torch.kernels import articulated as k7
    from quaternion_mpc_tpu_torch.kernels import expansions as k8
    from quaternion_mpc_tpu_torch.kernels import line_search as k2
    from quaternion_mpc_tpu_torch.kernels import rollout as k9
    from quaternion_mpc_tpu_torch.kernels import srb_post as k11
    from quaternion_mpc_tpu_torch.kernels import walking_pre as k10

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = list(pool.map(lambda m: m.build(), (rs, k4, k7, k2, k8, k9, k10, k11)))
    rs._lib()
    k4._lib()
    k7._lib()
    k2._lib()
    k8._lib()
    k9._lib()
    k10._lib()
    k11._lib()
    print(f"[build] {', '.join(str(lib.relative_to(kbuild.BUILD_DIR.parent.parent)) for lib in libs)} "
          f"in {time.perf_counter() - t0:.1f} s")
    _print_ptxas(kbuild, rs, k4, libs)

    if hardware_only:
        phase_hardware(device, smi)
        phase_fleet(device, smi)
        print(f"[done] hardware and fleet only, no result line; wall "
              f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if graphs_only:
        phase_graphs(device, smi)
        print(f"[done] graphs only, no result line; wall {time.perf_counter() - t_start:.1f} s")
        return 0
    worst_f32 = phase_kernel_vs_plain(device)                  # 3
    worst_f32_scan, worst_f32_fused = phase_scan_vs_plain(device)
    k2_worst, k2_flips, k2_checks = phase_line_search_vs_plain(device)
    k8_worst, k8_main_abs = phase_expansions_vs_plain(device)
    k9_worst, k9_differ = phase_rollout_vs_plain(device)
    if kernels_only:
        phase_k7_kernels_only(device, baselines.get("--k7-baseline"))
        phase_small_kernel_vs_plain(device)
        phase_cross_term_vs_plain(device)
        phase_sweep_timing(device)
        phase_k1_shape_timing(device)
        if "--k1-baseline" in baselines:
            phase_k1_baseline(device, baselines["--k1-baseline"])
        phase_scan_timing(device)
        phase_line_search_timing(device)
        phase_expansions_timing(device)
        phase_rollout_timing(device)
        phase_k9_designs(device, baselines.get("--k9-baseline"))
        walk_states = _k10_walk_states(device)
        phase_k10_designs(device, walk_states, baselines.get("--k10-baseline"))
        k11_recs = _k11_states(device, walk_states)
        phase_srb_post(device, walk_states, k11_recs)
        phase_k11_designs(device, k11_recs, baselines.get("--k11-baseline"))
        phase_k2_designs(device, baselines.get("--k2-baseline"))
        if "--k8-baseline" in baselines:
            phase_k8_designs(device, baselines["--k8-baseline"])
        print(f"[done] kernels only, no result line; wall {time.perf_counter() - t_start:.1f} s")
        return 0
    ctrl, inputs, launches = phase_main_path(device)           # 4
    phase_fixture(device)                                      # 5
    phase_assoc_quality(device)
    step = phase_timing(ctrl, inputs)                          # 6
    sweep_times = phase_sweep_timing(device)
    k1_shape_times = phase_k1_shape_timing(device)
    scan_times, fused_times = phase_scan_timing(device)
    line_search_times = phase_line_search_timing(device)
    expansions_times = phase_expansions_timing(device)
    rollout_times = phase_rollout_timing(device)
    latency, k4_launches, scan_launches = phase_latency(device)               # 7
    convex_step, convex_launches = phase_convex(device)        # 8
    try:                                                          # 9
        step_profile = phase_profile(ctrl, inputs, step[4096], latency, device)
    except RuntimeError as e:  # a record, not a check: the tracer may be unavailable
        print(f"[profile] not measured: {e}")
        step_profile = None

    stand_s, stand_per = phase_standing_fleet(device)          # 10
    walk_step, walk_carry, walk_sp, walk_joy, walk_s, walk_per = phase_walking_fleet(device)
    one_s, one_per = phase_walking_one_robot(device)
    phase_stairs_gate(device)
    walk_states = _k10_walk_states(device)
    k10_res = phase_walking_pre(device, walk_states)
    k11_res = phase_srb_post(device, walk_states)
    phase_no_host_sync(walk_step, walk_carry, walk_sp, walk_joy)
    # held: the pre range holds K10 and the post range K11, each with no more
    # than a handful of other launches, so a tick the tracer did not record
    # fails here
    walk_profile = profile_walking_tick(walk_step, walk_carry, walk_sp, walk_joy, walk_s)
    for part, kernel in (("pre", "K10"), ("post", "K11")):
        split = (walk_profile or {}).get("split", {}).get(part)
        _check(split is not None, f"the walking tick's {part} range was not measured")
        _check(split["launches"] <= 4, f"the walking tick's {part} range ({kernel}) holds "
                                       f"{split['launches']} launches")
    # 11, with phase 12's workers beside it and, while the workers finish,
    # phase 12's checks that time nothing (kernel against plain; counted solves)
    single = {}

    def single_checks():
        single["worst_f32"], single["differ"] = phase_small_kernel_vs_plain(device)
        single["worst_f32_cross"], differ_cross = phase_cross_term_vs_plain(device)
        single["differ"].update(differ_cross)
        single["solve"], single["tick"], single["bicycle"] = phase_single_counted(device)

    est = phase_estimated_fleet(device, smi, beside_workers=single_checks)
    worst_f32_small, solve_launches, tick_launches, bicycle_launches = (
        single["worst_f32"], single["solve"], single["tick"], single["bicycle"])
    cat = phase_cat_fleet(device, smi)                         # 12, the timed part
    act = phase_actuated(device, smi)                          # 13
    hw = phase_hardware(device, smi)                           # 14
    fleet = phase_fleet(device, smi)                           # 15
    graphs = phase_graphs(device, smi)                         # 16
    sweep_times.update(k1_shape_times)
    per_tick = {"standing_2x5_B4096": stand_per, "walking_rti_1x3_B4096": walk_per,
                "walking_rti_1x3_B1": one_per, "estimated_2x5_B4096": est["per_tick"],
                "estimated_2x5_B1": est["per_tick_one"]}

    scan_n20 = scan_times["fixture N=20 B=1"]
    fused_n10 = fused_times[f"standing N={HORIZON} B=1"]
    sweep_main = sweep_times[_shape_tag(*K1_TIMED[0])]
    no_library = "no single PyTorch call computes this recursion (scan)"
    k7_main = act["timing"][f"float32 B={ACT_B} n_sub={ACT_N_SUB}"]
    print(json.dumps({"kernels": [{
        "name": "riccati_sweep",
        "route": "cuda",
        "source": "quaternion_mpc_tpu_torch/csrc/riccati_sweep.cu",
        "replaces": "experiments/pallas_fleet.py:161",
        # the fleet solves of phase 4 plus the counted estimated tick of phase
        # 11, each driven with the count set to 0 just before and read just after
        "launches": (launches + est["k1_launches"] + solve_launches + tick_launches
                     + bicycle_launches + cat["k1_launches"] + sum(act["k1_launches"].values())
                     + act["single_k1"] + sum(hw["k1_launches"].values())
                     + sum(fleet["k1_launches"].values())
                     + sum(graphs["k1_launches"].values())),
        "launches_by_path": {"fleet_solves_B256_4096_16384": launches,
                             "estimated_tick_B4096": est["k1_launches"],
                             "make_solver_default_6x10_quat_fixture": solve_launches,
                             "falling_cat_receding_tick_2x8": tick_launches,
                             "falling_cat_fleet_solve_3x25_B4096": cat["k1_launches"],
                             "bicycle_receding_solves_2x8_with_lux": bicycle_launches,
                             **act["k1_launches"],
                             "per_scenario_srb_steps_B1": act["single_k1"],
                             **hw["k1_launches"], **fleet["k1_launches"],
                             **{f"graphed {k}": v for k, v in graphs["k1_launches"].items()}},
        "max_abs_err": worst_f32,
        # over phase 12's shapes below 12 x 12, whose outputs reach 8e4 (dV1 of
        # the double integrator): each is held relative to its own scale
        "max_abs_err_embedded_shapes": worst_f32_small,
        # phase 12's launches at each instantiation against the parent's
        # (embedded in 12 x 12) on the same inputs: [elements that differ, of]
        "elements_differing_from_12x12_launch": single["differ"],
        # every instantiation: its time at a path's shape beside its bound
        "instantiations": {tag: {k: t[k] for k in ("ms", "bound_ms", "share_of_bound")}
                           for tag, t in {f"{_shape_tag(*K1_TIMED[0])} (12x12)": sweep_main,
                                          **k1_shape_times}.items()},
        "max_abs_err_with_cross_term": single["worst_f32_cross"],
        "ms": sweep_main["ms"],
        "plain_ms": sweep_main["plain_ms"],
        "bound_ms": sweep_main["bound_ms"],
        "bound_by": sweep_main["bound_by"],
        "library_ms": None,
        "library": no_library,
        "shape": _shape_tag(*K1_TIMED[0]),
        "by_shape": sweep_times,
        "convex_launches": convex_launches,
        "convex_step_ms": convex_step * 1e3,
        "closed_loop_launches_per_tick": {**{k: v[0] for k, v in per_tick.items()},
                                          "actuated_2x4_B64": 8, "actuated_2x4_B4096": 8,
                                          **hw["k1_per_tick"]},
        "closed_loop_ms_per_tick": {"standing_2x5_B4096": stand_s * 1e3,
                                    "walking_rti_1x3_B4096": walk_s * 1e3,
                                    "estimated_2x5_B4096": est["p50"] * 1e3,
                                    "actuated_2x4_B64": act["fleets"][ACT_B]["p50"] * 1e3,
                                    "actuated_2x4_B4096": act["fleets"][ACT_BIG_B]["p50"] * 1e3},
        "estimated_tick_ms_min_max": [est["min"] * 1e3, est["max"] * 1e3],
        "falling_cat_fleet_solve_ms": {"p50": cat["p50"] * 1e3, "min": cat["min"] * 1e3,
                                       "max": cat["max"] * 1e3},
        "falling_cat_fleet_geodesic_max": cat["geodesic_max"],
        "falling_cat_fleet_torque_max": cat["torque_max"],
        "falling_cat_fleet_runaway_starts": {"f32": cat["runaways"],
                                             "f64": cat["runaways_f64"]},
        "walking_tick_profile": walk_profile,
        "estimated_tick_profile": est["profile"],
        "hardware_graphs_launches_per_replay": hw["graphs_launches_per_replay"],
        "hardware_tick": hw["tick"],
        "hardware_tick_f64_card_vs_cpu_rel": hw["worst_f64"],
        "hardware_threaded_loops": hw["threaded"],
        "hardware_fresh_process_walks": hw["fresh_walks"],
        "cli_run_fleet_B4096": fleet["cli"],
        "cli_bench_solver_p50_step_ms_B4096": hw["cli_p50_step_ms_B4096"],
        "cli_run_hardware": hw["cli_run_hardware"],
        # phase 16: each entry point's CUDA graph against its eager run
        "entry_point_graphs": graphs["paths"],
        "assoc_vs_sweep_B1_replayed_ms": graphs["assoc_vs_sweep_B1"],
        "cli_graphed_in_process": graphs["cli"],
    }, {
        "name": "assoc_scan",
        "route": "cuda",
        "source": "quaternion_mpc_tpu_torch/csrc/assoc_scan.cu",
        "replaces": "quaternion_mpc_tpu/solver/parallel_riccati.py:172",
        "launches": scan_launches,
        "on_main_path": "no: the solver's path launches assoc_backward, which holds the scan",
        "max_abs_err": worst_f32_scan,
        "ms": scan_n20["ms"],
        "plain_ms": scan_n20["plain_ms"],
        "bound_ms": scan_n20["bound_ms"],
        "bound_by": scan_n20["bound_by"],
        "library_ms": None,
        "library": no_library,
        "shape": "f32 N=20 B=1",
        "by_shape": scan_times,
    }, {
        "name": "assoc_backward",
        "route": "cuda",
        "source": "quaternion_mpc_tpu_torch/csrc/assoc_scan.cu",
        "replaces": "quaternion_mpc_tpu/solver/parallel_riccati.py:132",
        "launches": k4_launches + est["k4_launches"],
        "launches_by_path": {"latency_rows_B1": k4_launches,
                             "estimated_ticks_B1": est["k4_launches"]},
        "max_abs_err": worst_f32_fused,
        "ms": fused_n10["ms"],
        "plain_ms": fused_n10["plain_ms"],
        "bound_ms": fused_n10["bound_ms"],
        "bound_by": fused_n10["bound_by"],
        "library_ms": None,
        "library": no_library,
        "shape": f"f32 N={HORIZON} B=1",
        "by_shape": fused_times,
        "latency_ms_per_tick": {label: {"auto": a, "sweep": sw} for label, a, sw in latency},
        "closed_loop_launches_per_tick": {k: v[1] for k, v in per_tick.items()},
        "closed_loop_ms_per_tick": {"walking_rti_1x3_B1": one_s * 1e3},
    }, {
        "name": "articulated_step",
        "route": "cuda",
        "source": "quaternion_mpc_tpu_torch/csrc/articulated.cu",
        "replaces": "quaternion_mpc_tpu/sim/articulated.py:283",
        "design": (f"a lane per leg, four lanes a scenario, {k7.THREADS} lanes a block; the "
                   "torso's sums over the legs by __shfl_xor_sync, the torso updated in every "
                   "lane; the parameters staged in shared memory once a launch"),
        # the actuated ticks of phase 13, each run driven with the count set
        # to 0 just before and read just after (exactly one a tick)
        "launches": (sum(act["k7_launches"].values()) + sum(hw["k7_launches"].values())
                     + sum(graphs["k7_launches"].values())),
        "launches_by_path": {**act["k7_launches"], **hw["k7_launches"],
                             **{f"graphed {k}": v for k, v in graphs["k7_launches"].items()}},
        # f32 against the plain step in f64, outside the scenarios whose f32
        # plain step flips a stick / slip decision (act["flips"] of 4096)
        "max_abs_err": act["worst_f32"],
        "max_abs_err_f64": act["worst_f64"],
        "f32_stick_slip_flips_of_4096": act["flips"],
        "ms": k7_main["ms"],
        "plain_ms": k7_main["plain_ms"],
        "bound_ms": k7_main["bound_ms"],
        "bound_by": k7_main["bound_by"],
        "library_ms": None,
        "library": "no single PyTorch call integrates this plant",
        "shape": f"float32 B={ACT_B} n_sub={ACT_N_SUB}",
        "by_shape": act["timing"],
        "actuated_tick_ms": {f"B={b}": {k: v * 1e3 for k, v in f.items()}
                             for b, f in act["fleets"].items()},
        "plain_plant_tick_ms_B64": act["plain_tick_ms"],
        "actuated_tick_profile": act["profile"],
    }, *({
        "name": "line_search" if inst == "quat_srb_midpoint" else f"line_search[{inst}]",
        "route": "cuda",
        "source": "quaternion_mpc_tpu_torch/csrc/line_search.cu",
        "replaces": "quaternion_mpc_tpu/solver/fleet.py:757",
        "instantiation": inst,
        "design": ("a thread per (alpha, scenario), two up to a full wave of blocks, a "
                   "scenario's lanes side by side in a warp; constants and each knot's slab "
                   "staged in shared memory by cp.async, double-buffered; the pricing spread "
                   "over the scenario's lanes; every alpha's rollout kept, the selected one "
                   "written by the whole block; the model a template argument"),
        # every counted path of this process that runs this instantiation,
        # each driven with the count set to 0 just before and read just after
        # (K2 al x ilqr a solve)
        "launches": sum(K2_LAUNCHES.get(inst, {}).values()),
        "launches_by_path": dict(K2_LAUNCHES.get(inst, {})),
        "max_abs_err": k2_worst[inst],
        "ms": line_search_times[K2_MAIN_OF[inst]]["ms"],
        "plain_ms": line_search_times[K2_MAIN_OF[inst]]["plain_ms"],
        "bound_ms": line_search_times[K2_MAIN_OF[inst]]["bound_ms"],
        "bound_by": line_search_times[K2_MAIN_OF[inst]]["bound_by"],
        "library_ms": None,
        "library": "no single PyTorch call computes this line search",
        "shape": K2_MAIN_OF[inst],
        "by_shape": {tag: t for tag, t in line_search_times.items()
                     if K2_MODEL.get(tag.split(" ")[0], "quat_srb_midpoint") == inst},
        **(dict(f32_flips_in_all_checks=k2_flips, checks=k2_checks,
                hardware_tick_replay_ms_p50_min_max=[hw["tick"][k] for k in ("p50_ms", "min_ms",
                                                                            "max_ms")],
                hardware_tick_replay_device_ops=hw["tick"]["replay_profile"]["device_ops"],
                three_tier_walks_upright_of_4=sum(
                    bool(s["upright"]) for s in hw["fresh_walks"]["three_tier_walks"]))
           if inst == "quat_srb_midpoint" else {}),
        **(dict(convex_step_ms=convex_step * 1e3) if inst == "euler_srb_midpoint" else {}),
        **(dict(falling_cat_fleet_solve_ms=cat["p50"] * 1e3) if inst == "attitude_midpoint"
           else {}),
    } for inst in K2_MAIN_OF), *({
        "name": "expansions" if inst == "quat_srb_midpoint" else f"expansions[{inst}]",
        "route": "cuda",
        "source": "quaternion_mpc_tpu_torch/csrc/expansions.cu",
        "replaces": "quaternion_mpc_tpu/solver/fleet.py:642",
        "instantiation": inst,
        "design": ("a block a knot and 32 scenarios, its warps the knot's pieces (As, Bs, the "
                   "state cost, the AL terms, luu a few rows a warp after a barrier), the "
                   "terminal knot a tile a warp; shared leaves staged in shared memory; every "
                   "element of the dense slabs written from registers; batch-first parameters "
                   "read in place; -fmad=false; the model a template argument"),
        # every counted path of this process that runs this instantiation,
        # each driven with the counts set to 0 just before and read just
        # after: al x ilqr a solve or tick, as K2's
        "launches": sum(K8_LAUNCHES.get(inst, {}).values()),
        "launches_by_path": dict(K8_LAUNCHES.get(inst, {})),
        "max_abs_err": k8_main_abs[inst],
        "max_rel_err_over_checked_shapes": k8_worst,
        "ms": expansions_times[K8_MAIN_OF[inst]]["ms"],
        "plain_ms": expansions_times[K8_MAIN_OF[inst]]["plain_ms"],
        "bound_ms": expansions_times[K8_MAIN_OF[inst]]["bound_ms"],
        "bound_by": expansions_times[K8_MAIN_OF[inst]]["bound_by"],
        "library_ms": None,
        "library": "no single PyTorch call computes these expansions",
        "shape": K8_MAIN_OF[inst],
        "by_shape": {tag: t for tag, t in expansions_times.items()
                     if K8_MODEL.get(tag.split(" ")[0], "quat_srb_midpoint") == inst},
        "registers": {k: v for k, v in _k8_registers(kbuild, libs[4]).items()
                      if k.startswith(inst)},
        **(dict(fleet_step_profile_B4096=step_profile,
                hardware_tick_replay_device_ops=hw["tick"]["replay_profile"]["device_ops"])
           if inst == "quat_srb_midpoint" else {}),
        **(dict(convex_step_ms=convex_step * 1e3) if inst == "euler_srb_midpoint" else {}),
        **(dict(falling_cat_fleet_solve_ms=cat["p50"] * 1e3) if inst == "attitude_midpoint"
           else {}),
    } for inst in K8_MAIN_OF), *({
        "name": entry if inst == "quat_srb_midpoint" else f"{entry}[{inst}]",
        "route": "cuda",
        "source": "quaternion_mpc_tpu_torch/csrc/rollout.cu",
        "replaces": K9_ENTRIES[entry],
        "instantiation": inst,
        "design": ("every knot's drive (the inputs' part of the step) first, a thread a (knot, "
                   "scenario), to shared memory; then a thread a scenario runs the chain of "
                   "advances, x in registers, each xs row written coalesced" if entry == "rollout"
                   else "four lanes a (knot, scenario), lane q the rows r ≡ q (mod 4), combined by "
                   "shuffles; the tile's Cu, cb and λ staged by cp.async; the final cost a tile's "
                   "knots in one block, summed after a barrier; the multiplier update a grid over "
                   "(tile, knot group)")
                  + "; PyTorch's rounding and order of summation, -fmad=false; the model a "
                    "template argument (csrc/step_models.cuh, K2's structs)",
        # every counted path of this process that runs this instantiation,
        # each driven with the counts set to 0 just before and read just
        # after: the rollout once a solve, the pricing al + 1 times
        "launches": sum(K9_LAUNCHES.get(entry, {}).get(inst, {}).values()),
        "launches_by_path": dict(K9_LAUNCHES.get(entry, {}).get(inst, {})),
        "max_abs_err": k9_worst[entry].get(inst, 0.0),
        # over phase 3's checks at B > 1: [elements that differ, of]
        "elements_differing_at_B_gt_1": ({"xs": k9_differ["xs"]} if entry == "rollout" else
                                         {"lam_bar": k9_differ["lam_bar"], "J": k9_differ["J"]}),
        **{k: rollout_times[f"{K2_MAIN_OF[inst]} "
                            f"{'rollout' if entry == 'rollout' else 'final cost'}"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "library": f"no single PyTorch call computes this {entry}",
        "shape": f"{K2_MAIN_OF[inst]} {'rollout' if entry == 'rollout' else 'final cost'}",
        "by_shape": {tag: t for tag, t in rollout_times.items()
                     if (entry == "rollout") == tag.endswith("rollout")
                     and K2_MODEL.get(tag.split(" ")[0], "quat_srb_midpoint") == inst},
        "registers_stack_spill": {k: v for k, v in _k9_registers(kbuild, libs[5]).items()
                                  if k.startswith(f"{entry} {inst}")},
    } for entry in K9_ENTRIES for inst in K2_MAIN_OF), {
        "name": "walking_pre",
        "route": "cuda",
        "source": "quaternion_mpc_tpu_torch/csrc/walking_pre.cu",
        "replaces": "quaternion_mpc_tpu/runtime/step.py:1516",
        "design": ("four lanes a scenario, eight a warp: lane g its leg g, the scenario's "
                   "chain in the group with its divisions and half-angle sines dealt over the "
                   "lanes; every input read before the first store, the window buffers staged "
                   "by cp.async, written out coalesced and summed over the group's lanes in "
                   "PyTorch's reduction order; cuBLAS's order for each einsum product; "
                   "-fmad=false"),
        # every walking path of this process, each driven with the count set
        # to 0 just before and read just after (exactly one a tick)
        "launches": sum(K10_LAUNCHES.values()),
        "launches_by_path": dict(K10_LAUNCHES),
        "max_abs_err": k10_res["worst_abs"]["float32"],
        "max_rel_err_of_scale": k10_res["worst"],
        # on the walks' and the estimated fleet's states: [elements that differ, of]
        "elements_differing": k10_res["differ"],
        **{k: k10_res["timing"][f"float32 B={CLOSED_LOOP_B}"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "library": "no single PyTorch call computes this stage",
        "shape": f"float32 B={CLOSED_LOOP_B}",
        "by_shape": k10_res["timing"],
        "registers_stack_spill": k10_res["registers"],
    }, {
        "name": "srb_post",
        "route": "cuda",
        "source": "quaternion_mpc_tpu_torch/csrc/srb_post.cu",
        "replaces": "quaternion_mpc_tpu/sim/plant.py:109",
        "design": ("a thread a scenario, its state in registers; the mode and the push as "
                   "template arguments; inputs read in place through (batch, element) strides; "
                   "PyTorch's reduction order for each sum and norm, torch.linalg.cross's fused "
                   "terms and cuBLAS's order for each einsum product; -fmad=false"),
        # every SRB path of this process, each driven with the count set to 0
        # just before and read just after (exactly one a tick)
        "launches": sum(K11_LAUNCHES.values()),
        "launches_by_path": dict(K11_LAUNCHES),
        "max_abs_err": k11_res["worst_abs"]["float32"],
        "max_rel_err_of_scale": k11_res["worst"],
        # on the walks', the estimated and the standing fleets' states:
        # [elements that differ, of]
        "elements_differing": k11_res["differ"],
        **{k: k11_res["timing"][f"walking float32 B={CLOSED_LOOP_B}"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "library": "no single PyTorch call computes this stage",
        "shape": f"walking float32 B={CLOSED_LOOP_B}",
        "by_shape": k11_res["timing"],
        "registers_stack_spill": k11_res["registers"],
    }]}))
    print(f"[done] wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
