"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. It builds the kernels of
``pyhybridcontrol_tpu_torch/csrc/`` with nvcc, then:

  1. prints the card's name and power limit (nvidia-smi) and the build time;
  2. K1 (σ=0 batched ADMM) against its plain torch version on the card:
     config 1's enumeration batch (N=10, B=1024, 400 iterations) and the
     bench-primary batch (N=20, B=4096, 100 iterations, cold and warm),
     plus an infeasible instance; median CUDA-event times of both;
  3. K2 (fused B&B wave) against its plain version: config 1's wave
     (N=10, B=32, 400+400 iterations, stiff probe) and N=20 (B=4096),
     cold and warm-started (every B&B wave after the root is warm);
  4. K1 and K2 far from convergence (config 1, 30 iterations, 15+15 probe
     iterations), where a wrong step — over-relaxation, iteration count,
     a swapped output — shows, at batch sizes 1, 3, 32, 33 and 257, with
     and without the stiff probe; and the shape limit: asked to stage
     constants that do not fit in shared memory (N=60), the wrapper must
     refuse, not fall back, and the plan deals them over a cluster; every
     problem-tile
     instantiation of K1/K2 (8, 4, 1 problems per block) at batches
     that are no multiple of the tile, and the instantiation, threads and
     shared memory the wrapper's plan picks at each main shape;
  5. K1's split-precision phase (``low_frac``, bf16 3-pass products on
     the tensor cores) against its plain version at the reference test's
     shape (N=12, B=128, 120 iterations) and at the bench primary (N=20,
     B=4096, 100 iterations): the tensor-core kernel's own outputs (the
     iterates z_G, y_G, z_B, y_B) after ONE split-precision iteration
     from the same warm iterates (the plain version's after 10 and 50
     iterations), before the bf16 steps drift apart, and objective and
     solution of the whole solve at ``low_frac`` 0.8 and 1.0; then the
     reference bench's own gate: max relative objective delta of
     ``low_frac=1.0`` against full-precision K1 ≤ 1e-4. Both tile widths
     of the kernel (16 and 32 problems per block) at batches that leave a
     ragged last tile (N=12: B=1, 33, 4095; N=20: B=4095) and N=21 (a tile
     of 16 only), one iteration at every width and the whole solve at the
     plan's; the plan against the library's own reckoning; its plan
     must refuse N=22, whose constants do not fit, which routes to K1's
     split mode (phase 10);
  6. no plain version behind a CUDA tensor: with the plain versions made
     to raise, ``admm_solve_auto``, ``admm_wave_auto`` and
     ``admm_solve_cuda(low_frac>0)`` still answer and count their launches,
     at N=10 and at N=27 (resident variants, split mode);
  7. the single-state serving path: the port's serve stdin loop, in process,
     on ``--config double_integrator --device cuda`` — a ping, four
     feasible states, one state outside the box, quit. Every feasible
     objective must be within ``serve_limit`` of the port's enumeration
     solver on the card (600 iterations); the out-of-box state must come back
     found=false; K2's launch count must grow during the phase;
  8. the batched serving path: ``--config scenario_batch`` (config 4, full
     width: N=10, 1024 instances, pool 32,768, global wave 1024) — one
     2-D request of 1024 seeded states, one of them outside the box,
     through the stdin loop. The reply is list-valued; the out-of-box
     instance is found=false; on a fixed sample of 64 instances ``found``
     and the objective (``serve_limit``) agree with the enumeration
     controller on the card; every K2 launch had B=1024. Then
     ``solve_miqp_bnb_pooled`` with the reference bench's config-4 spec
     (wave 1024, probe_patience=3, pool 8·B), once from nothing and once
     carrying the first call's incumbents: objectives within
     ``serve_limit`` of the request's; the probe gate closes on the
     second only, where K1 must launch at B=1024. Then the relaxation
     sweep that uses the split-precision phase (N=20, B=4096,
     ``low_frac=1.0``);
  9. K1/K2 where a block cannot stage Â_G and Mᵀ, with the constants
     resident over a thread-block cluster (the plan's variant): first one
     cluster barrier's cost at C = 1 to 16; then against their plain
     versions and, bitwise on x, z and y (stats within 1e-12, certificate
     bits identical), against the L2-streamed variant forced at the tile
     that sums in the same order: the real condensed problems of the
     reference bench's configs 2 (n=220, m=680), 3 (108/239), 4b
     (120/216) and 4c (the dense joint frame of its scenario tree,
     120/444, node boxes fixing whole information-set groups) at seeded
     states and node boxes, a random problem of the size of the double
     integrator at N=27, at B = 1, 37 and 300; the streamed and resident
     variants forced at N=26 against the staged one; the times at the N=27
     paths' shapes; then resident K2 at the waves of the config-2 call
     (B=128, 200 + 600 iterations), the served config-2 request (B=64,
     400 + 400), config 3's loop (B=64) and config 4b's loop (B=1024), and
     resident K1 on the gated waves of configs 2 and 4b, each with its
     plan and both variants' times (the relaxations at the "main" limits,
     the long probes of those waves at "wave_probe"); then config 4c's
     waves at "main": resident K1 at its pooled wave (B=1024: the
     relaxation, 100 iterations, and the probe on group-rounded boxes, 200
     iterations at ρ·10 then 200 at ρ) and resident K2 at the wave of a
     single-instance dense-tree ``feedback`` (B=64, 100 + 200/200);
 10. K1's split mode (the split-precision phase where the tensor-core
     kernel refuses the shape, N ≥ 22): one split iteration from the
     plain version's iterates, the whole solve's objective and solution
     at N=22, 24 and 27, and the bench's 1e-4 gate at N=24; at N=27
     (resident) bitwise against the L2-streamed variant;
 11. config 1 of the reference bench as a closed loop: N=10, T=20 from
     [2, 0], B&B (capacity 256, wave 32, 48 waves, 200 iterations, probe
     at ρ=10); ms per control step, found share, mean nodes; held against
     the port's enumeration loop (total cost rtol 2e-3, states 1e-2);
 12. the N=27 double integrator: a closed loop of 4 steps (K2 resident)
     that must find every step, follow the dynamics and end nearer the
     origin, then the relaxation sweep at ``low_frac=1.0`` (K1 resident in
     split mode) against its plain version;
 13. config 2 served: ``--config pwa_actuator`` (PWA spring, hull, N=20)
     through the stdin loop — a ping, three states, one outside the box
     (found=false), quit; each plan held in fp64 against the port's
     CondensedMpc (G V ≤ h, box, binaries 0/1, within the B&B's own
     feas_tol) and its objective recomputed from the plan (serve_limit);
 14. the reference bench's config-2 and config-2b calls from [1.5, 0]
     (repair seed, probe at ρ=10, wave 128, 200 + 600 iterations,
     probe_patience=3; 2b: rel_gap 0.02, capacity 8192, 128 waves): ms
     per solve, nodes, objective, certified gap, the plan in fp64;
 15. an exact hold where enumeration reaches: config 2's hull frame at
     N=4 (12 binaries) and config 3's frame at N=6 (15 binaries), five
     states each — B&B within serve_limit of the port's enumeration on the
     card, the enumeration within 1e-3 of the port's fp64 oracle (a
     branch and bound on fp64 QP solves that picks its leaves itself);
 16. config 3 of the bench as a closed loop (DEWH, min-up 2, blocks of
     two steps, soft comfort band; N=24, T=12 from [55, 0], seeded draws):
     found share 1.0, every step's plan feasible in fp64, ms per control
     step; the golden thermal_uc_N12_T8 replayed (total cost, rtol 2e-3);
 17. config 4b: 1024 DEWH instances in a pooled closed loop (N=24, T=8,
     wave 1024, pool 8·B): found share 1.0, every K1/K2 launch at B=1024,
     64 first-step plans feasible in fp64, control steps/s, MIQP/s; the
     golden dewh_loop_B8_N12_T4 replayed;
 18. config 4c of the reference bench (bench.py:654-701): 256 scenario-tree
     MIQPs (the double integrator with a velocity disturbance, S=4, N=10,
     branching at steps 1 and 5) through ``feedback_batch(engine=
     "pooled")`` with rep-map branching, 3 repetitions: the wave path by
     its true name ("unfused K1 relax + probe": every K1 launch at
     B=1024, no K2), found share 1.0, 32 plans feasible in fp64 against the
     port's joint frame (non-anticipativity rows included), 16 instances
     within ``serve_limit`` of the port's single-instance ``feedback`` on
     the same tree (K2 at B=64, per-coordinate branching); tree-MIQP/s,
     mean objective beside the reference's recorded −288.5737, waves,
     nodes;
 19. exact holds of the tree paths: tests/test_bnb_pooled.py's S=2, N=4
     tree through the pool within 1e-3 of the port's fp64 oracle, and the
     consensus tree (plain torch ADMM) on tests/test_consensus_tree.py's
     fixture (S=4, N=6) against the dense joint build (objective 2e-3,
     first input 2e-2).
 20. K4, the stagewise sweep (``csrc/stagewise.cu``), against its plain
     version (``ops/stagewise._solve_K``, torch ops on the card), run with
     the kernel phases (after 10) so that ``--readings`` reads it: config
     6's long-arm frame (P=64: a wave of 8 nodes × S=8, N=120, b=5) at ρ
     and ρ·10, staged and through L2, its parity arm's (P=64, N=4), the
     frames of phase 21's served double integrator (P=32, N=10) and of
     its transforms hold (P=16, N=8) at ρ and ρ·10, a double-integrator
     frame at N=40 with P = 1, 33, 257, the PWA hull model (b=13) at
     N=20, within the "sweep" limit, and random factors at b = 20, 40,
     100 (the wider instantiations), within "sweep_wide"; then the whole
     stagewise tree relaxation (150 iterations; each path warm, median of
     3) and the 1000-iteration probe at ρ·10 on config 6's frame through
     the torch loop with K4 (the path K5 replaced; no driven path launches
     K4 since) against the torch loop with the plain sweeps, within
     "main", certificate bits identical. K4 alone, its
     wrapper and the plain sweeps timed, its bound, its chain floor, and
     ``torch.linalg.lu_solve`` on the dense LU of K as the library call;
 21. config 6 of the reference bench (bench.py:742-816), nothing cut, with
     the plain loop and sweeps made to raise: the parity arm (S=2, N=4)
     within 1e-3
     of the port's fp64 oracle on the dense joint frame; the long arm
     (S=8, N=120 branching at 1, 40, 80, Σu ≤ 60; capacity 64, wave 8, 6
     waves, 150 + 1000 iterations at ρ·10) one warm-up and the median of
     3, its objective within 1e-3 of the JAX package's recorded one, its
     plan feasible in fp64 (dynamics, stage rows, binaries, shared u/δ in
     every information set, the budget on every path), on each arm K5
     launched once a relaxation or probe and nothing else, at a multiple
     of S; the device's idle share over one wave's relaxation (one K5
     launch) under torch.profiler; ``serve --config double_integrator
     --solver stagewise`` through the stdin loop (a ping, three states, one
     out of the box), objectives within ``serve_limit`` of the port's
     condensed enumeration plan valued in the stagewise frame; and the
     stagewise controller with soft rows, move blocking, a terminal set
     and a budget row at once (N=8), on the card within 1e-3 of the same
     on the CPU (each served and held path also K5 once a solve); then the
     long arm's ``parallel_sweeps=True`` twin (path config6_long_par):
     every relaxation and probe one launch of K5's parallel sweep in the
     shared variant, found as the sequential solve, its objective within
     1e-3 of that solve's and of the JAX package's with the log-depth
     sweeps (CFG6_REF_OBJ_PAR), its plan feasible in fp64, read again warm
     (K5's launches, iterations and event time, the idle share);
 22. K5, the stagewise ADMM loop (``csrc/stagewise.cu``), against its
     plain version (``ops/stagewise._admm_iterations``: the torch loop
     with the plain sweeps, on the card), run with the kernel phases
     (after 20): at every driven stagewise shape — config 6's long arm (a
     wave of 8 nodes × S=8, N=120, the budget row) and parity arm (32 ×
     S=2, N=4), the served double integrator (N=10, a wave of 32) and the
     transforms hold (N=8, a wave of 16) — the served double integrator
     from out of the box (every node infeasible), the wider blocks no
     driven path reaches (the PWA hull model, b=13; a double integrator
     with a second force, b=6) and the double integrator with its state
     box soft at every stage from a state outside it (N=10, a wave of 16:
     the soft rows' prox binds there, on no driven path), the very calls a
     B&B wave makes at ρ (the relaxation, 150 iterations, cold and warm)
     and ρ·10 (a 200-iteration probe on rounded boxes, warm): x, z, y, dy
     and the extra rows' z_e, y_e, dy_e within "k5" ("k5_wide",
     "k5_soft", "k5_infeasible" at those shapes), config 6 and the wider
     blocks also with the unstaged variant forced; certificate bits equal
     to those of the plain loop's carries but near a threshold; K5 alone,
     its wrapper and the plain loop timed at each shape, its roofline
     bound and its chain floor (iterations × ``k4_chain_ms``);
 23. K2 at the waves the user-facing surfaces give it, run with the kernel
     phases (after 22), warm, against its plain version on node problems
     of each frame ("microgrid" and "surfaces" limits): the micro-grid
     coordinator's aggregate frame at 4 agents (N=24, 480/888, B=32,
     200 + 200 iterations, stiff probe), where no cluster holds the
     constants and
     the plan streams them from L2, and at 3 agents (360/672, resident
     over 16 CTAs; also bitwise against the L2-streamed variant), a dual
     round of the decentralized agents (8 × a wave of 16, staged) and
     config 5's global wave (512 × 64 nodes of N=20, 300 + 300, staged);
     each with its plan and times beside the bound;
 24. ``python -m pyhybridcontrol_tpu_torch.run`` in process through
     ``main(argv)`` at full width: config 1 at T=40 with ``--log`` (read
     back), config 3 for 8 steps, config 2 for 3, configs 4 (B=1024) and
     5 (B=512, N=20: a global wave of 32,768 nodes and a pool of 524,288,
     on one card) as one pooled batch each (every K2 launch at the global
     wave), found share 1.0 on each; config 1 for 6 steps in chunks of 2
     with snapshots, within rtol 1e-4 of the unchunked study, resumed to 8
     steps and again (a no-op);
 25. the micro-grid coordinator at its N=24 with the example's spec and
     P_max = (M−1)·3 kW: 3 agents for 4 steps (resident K2), 4 for 2 (the
     L2-streamed K2, which no other driven path takes): the coupling held
     each step, each plan feasible in fp64, each visited state's
     objective at N=2 within MG_ORACLE_REL of the fp64 oracle;
 26. the decentralized micro-grid, 8 agents at N=8, 3 steps: every dual
     round one pooled B&B whose every K2 launch covers all agents' wave,
     the coupling held after rationing, λ printed;
 27. the five examples' ``main`` at small arguments;
 28. K1 at root strong branching's batch, run with the kernel phases
     (after 23): config 2's 120 candidate children of the root (each one
     binary fixed), 400 iterations warm from the root relaxation, against
     its plain version ("strong_branching" limits, certificate bits
     identical: ``sb_fix`` fixes binaries from them), timed beside its
     bound;
 29. config 2's search arms after the config-2/2b calls
     (scripts/config2_sb_ab.py's config-2 arm: capacity 2048, wave 128, 64
     waves, 200 + 600 iterations, rel_gap 0.02): none, sb_iters=400,
     + sb_fix, + root_iters=3200 and dive_slots=16, depth_tiebreak=1e-2,
     flipdelta, each a path: plans feasible in fp64, waves = K2 + gated
     K1, strong branching's one K1 launch at B=120 apart, no arm's
     certified lower bound above another's objective (serve_limit), the
     JAX package's CPU readings printed beside; K2 held and timed on the
     dive lane's last wave;
 30. config 2's split cuts (host fp64, the trust box [0.5, −1]–[2.5, 1])
     and arm (d) on the cut frame: its plan feasible on both frames, its
     objective no lower than the arms' certified bounds, K2 held and timed
     on its last wave, an x0 outside the box refused on host and card;
 31. ``condense_device`` on the card against the host fp64 build (config
     6's model at N=120; 64 DEWH variants at N=24 in one batched call) and
     ``affine_scan_rollout`` against an fp64 simulation ("condense");
 32. K2 at the per-rank waves of phase 33 that no other phase holds (run
     with the kernel phases, after 28): config 5's pool wave on its frame
     (the PWA spring, big-M, N=14; B=256, 300 + 300 iterations) and the
     slice of ``feedback_batch(mesh=)`` (the N=20 double integrator at the
     pooled engine's global wave of 1024), warm, against the plain
     version ("md_pool" and "wave_probe", "md_slice" limits); phase 20
     holds K4 at a rank's half of config 6's wave (P=32);
 33. the multi-device layer (parallel/): one world of 8 ranks spawned on
     the card (one card, so gloo; payloads staged through the host) and
     sub-meshes of its first 2, 4 and 8 ranks, single-card references
     first: config 5's sharded pool (scripts/config5_pool4096.py: 8 ranks
     × 512 slots, wave 256, 40 waves, 300 iterations, repair seed) found
     with the same objective bitwise on every rank and within 1e-3 of one
     card at 4096 slots; the N=10 double integrator at P=2 and 4, an
     out-of-box state (found on no rank) and the ``rel_gap`` stop, within
     ``serve_limit`` of one card; ``feedback_batch(mesh=)`` at config 5's
     batch (512 × N=20 over 4 ranks) within 1e-3 per instance of one card;
     ``condense_horizon_sharded`` at config 6's model, N=120, over 4 ranks
     ("condense" limits); the consensus tree of phase 19 (S=4) over 2 and
     4 ranks within 5e-3 of one card (4 waves of 300 + 600 iterations);
     config 6's long arm over 2 ranks (the torch loop with K4 an
     iteration, one all_reduce an iteration; 3 waves) within 1e-3 of K5's
     objective on one card at the same cap, and with
     ``parallel_sweeps=True`` (path md_stagewise_tree_par: K6's windowed
     sweep an iteration, no K4 or K5 on any rank; obj, found and x the same
     on every rank) within 1e-3 of K5's parallel sweep on one card; then a
     one-rank NCCL
     world whose sharded B&B is the unsharded loop bitwise. Per path: the
     ranks, waves, ms a wave, collective calls, bytes and ms, K1, K2 and
     K4 launches a rank. Eight ranks time-slicing one card measure the
     machinery, not scaling;
 34. the mixed schedule, run with the kernel phases (after 32), one path
     (``mixed_schedule``): ``admm_solve_mixed`` at the bench's mixed
     section's shape (N=20, B=4096, 100 iterations) at low_frac 0.8 (the
     tensor-core split phase, then K1's tail) and 1.0 (as in the
     reference, one full-precision solve), and at N=27, 0.8 (K1's split
     mode and its tail in one launch); ``BoxQP.precision`` "high" at N=20
     and "default" (the one-pass split phase, a variant of both kernels)
     at N=20 and N=27; ``admm_solve_batch`` at config 1's shape (N=10, one
     state's 1-D q over enumeration's 2^10 boxes, 400 iterations). Every
     launch against its plain version ("mixed", "mixed_1pass", "main"),
     the one-pass kernels' own outputs after one iteration
     ("mixed_iterates_1pass"), the objectives against a full-precision K1
     solve beside the bench's 1e-4 gate (a reading), each case timed
     beside its bound;
 35. K5's grouped and global-state variants (the FLEX instantiations the
     plan takes where a group has more than 8 scenarios or a scenario's
     state outgrows a CTA's shared memory), run with the kernel phases
     (after 22): at each shape the two paths below run them at, a wave of
     nodes, 20 iterations from the kernel's own relaxation against the
     plain loop ("k5_flex", "k5_flex_wide" at the hull model's b=13), the
     plan's variant checked, the double integrator also with every array
     in device memory (global_all, forced), the wide trees' waves in one
     wave of portable clusters (checked against the clusters the card
     holds) and also at the grouped variant's earlier placement (⌈S/16⌉
     scenarios a CTA, non-portable clusters, forced), each placement
     logged (scenarios a CTA, cluster, place, threads, bytes, member
     lists, clusters the card holds, waves); at config 6's long-arm wave the
     grouped, global and global_all variants forced against the shared
     one, a whole relaxation warm, bitwise; each variant timed alone, as a
     wrapper and as the plain loop, at the held and the relaxation's
     iterations, beside its bound and chain floor;
 36. long horizons and wide trees (after 21), two paths, with the plain
     loop and sweeps made to raise: ``long_horizon``, one stagewise
     ``MpcController.feedback`` of the double integrator at N=1000 (N·nv
     3,000) and of the PWA hull model at N=300, each relaxation or probe
     one launch of the global variant, the first input printed beside the
     plan's fp64 feasibility (1e-3) where found; ``wide_tree``, config 6's
     long arm at S=16, 27 and 64 scenarios through the stagewise tree MIQP
     (probe prep at ρ·10; waves capped at 4), one launch of the grouped
     variant (the global one at S=64) a relaxation or probe, u₀'s spread
     over the scenarios below 5e-3, the plan feasible in fp64 with the
     budget row where found; the found share of each path; each solve again
     warm, timed (K5's launches, iterations and CUDA-event time) and under
     torch.profiler (the idle share against its own wall time);
 37. K5 at any b and any number of extra rows (the runtime-r
     instantiations, with the kernel phases after 35): a wave of nodes at
     each shape past the register path, 20 iterations from the kernel's
     own relaxation against the plain loop ("k5_any" at bmax 32 to 128,
     "k5_rt" at b=5): fleets of 5 (b=20, N=8; also forced through grouped,
     global and global_all), 8 (b=32, N=96: the battery_fleet path's
     shape), 16 (b=64, N=48) and 32 batteries (b=128, N=24); four of
     config 6's ω double integrators aggregated (b=20) in a tree of S=16
     (grouped); config 6's long arm with 5, 20 and 300 extra rows (the last
     with Aext, KiU and Cw in device memory); the plan's variant and
     placement printed; the time of each alone, of its wrapper and of the
     plain loop, the bound and the chain floor; then config 6's long arm
     (one extra row) forced through the runtime-r path, bitwise the
     register path's;
 38. the battery_fleet path (after 36): eight batteries aggregated, N=96,
     20 horizon-coupled rows, the TOU price (``fleet_controller``), one
     stagewise ``MpcController.feedback`` with the plain loop and sweeps
     made to raise, every relaxation and probe one launch of K5's global
     variant at bmax 32; found, objective (beside the JAX package's
     FLEET_REF_OBJ), nodes, relaxations and probes, u₀, the solve's time,
     a relaxation's and a probe's kernel time, and the plan's fp64
     feasibility, extra rows included; then its ``sw_parallel=True`` twin
     (path battery_fleet_par): every relaxation and probe one launch of
     K5's parallel sweep in the global variant, found as the sequential
     solve, its objective within 1e-3 of that solve's and of the JAX
     package's with the log-depth sweeps (FLEET_REF_OBJ_PAR), the kernel
     times beside the sequential ones, the plan in fp64 with the extra
     rows, read again warm; and (in 36) the wide trees' twins (path
     wide_tree_par) with their sequential solves' checks and u₀ spread,
     and the long horizons' solves beside the JAX package's objectives
     (LONG_REF_OBJ: the hull model finds no plan there either);
 39. K5's parallel sweep inside the shared and FLEX variants (the "_par"
     libraries; after 37), against its plain version (the plain loop with
     ``_solve_K_windowed`` on the plan's windows): at each shape the twins
     launch (config 6's relaxation and probe preps, the fleet's, the three
     wide trees) and two more (config 6's long arm with 5 extra rows, the
     runtime-r path at bmax 8; 32 batteries, bmax 128), 20 iterations from
     the sequential relaxation ("k5_par", "k5_par_probe", "k5_par_rt",
     "k5_par_any", "k5_par_any_probe": each prep its own); the
     parallel plan checked to be the sequential one with its windows; at
     config 6 grouped, global and global_all forced; each timed alone, as a
     wrapper and as the plain loop, beside its bound and both chain floors,
     and the relaxation alone in both sweeps, in turns; then held only at
     phase 22's short and wider shapes (windows of one or two stages at
     N=4 and 10, every row kind, b=6 and 13; "k5_par_small"; where the
     parallel plan is the horizon variant's, one scenario, the sweep
     inside the shared variant forced and timed against it) and phase
     37's staged wide ones (five batteries, the ω tree);
 40. K6, the stagewise sweep at any b and over windows
     (``csrc/stagewise_any.cu``; after 20), against its plain versions
     (``_solve_K``; ``_solve_K_windowed`` over ``any_windows(N)``
     windows, N a multiple of none) at config 6's long arm (b=5, N=120),
     the fleets' factors (b=32, N=96; b=128 and 160, N=24) and random
     factors (b=129, 137 odd, 256; b=700, P=3, the "l2" variant), each
     at P=1 and 64 (and fleet_b160's P=8), "k6" / "k6_random" limits,
     every plan variant (narrow, ring, l2; one launch and five) held and
     its shared memory against the kernel's count; at fleet_b160's wave
     every variant forced, bitwise the plan's output, and k6_wide's
     cycles a step by part; each timed alone, as a wrapper and
     as the plain version beside its bound (``k4_work``: factors, r and x
     at 3.35 TB/s; over windows also with the maps, carries and
     corrections counted, ``k6_windowed_bound_ms``), its chain floor and
     ``torch.linalg.lu_solve`` on the dense LU of K; then a tree past K5's
     clusters (S=272, b=5, N=8, a budget row), 20 iterations through the
     route (the torch loop with K4, or K6 over windows) against the plain
     loop on the same tensors ("k5_flex", "k5_par");
 41. the fleet_b160 paths (after 38): 40 batteries over N=24 (b=160, 43
     extra rows; ``fleet_controller``), one stagewise feedback, then its
     ``sw_parallel=True`` twin (fleet_b160_par), with K5 and the plain
     sweeps made to raise: the torch loop with K6 every relaxation and
     probe; found, nodes, relaxations and probes, the objective within
     1e-3 of the JAX package's CPU reading (FLEET_B160_REF_OBJ, _PAR), the
     plan in fp64 with its extra rows, K6's launches and none of K5's, a
     warm re-solve's time and idle share under torch.profiler (the
     sequential one; ``tools/k4_readings.py --k6`` profiles both).

Each phase prints its wall time, and the run its total. Launch counts are
kept per path (PATHS): set to 0 just before each served request set, the
pooled calls, the relaxation sweeps, the closed loops, the config-2 calls,
config 2's search arms and its cut-frame arm, config 4c's call and its single-instance feedbacks, config 6's two arms
and the served stagewise requests, each ``run`` invocation, the
checkpoint/resume study, each micro-grid run, the decentralized run and
the examples, each path of the multi-device phase (summed over its
ranks, each rank's counts set to 0 just before and read just after) and
the mixed schedule's calls, the long-horizon solves, the wide trees and
the battery fleet, and read just after it; launches made to compare a kernel with its
plain version or with enumeration fall in none of them.
A kernel's ``launches`` is its sum over these paths, ``launches_by_path``
the counts apart, and ``on_main_path`` says whether a served request
launched it. Every kernel launches on some path, but for the L2-streamed
K1 and K5 with every array in device memory (FORCED_ONLY), which must
launch on none: no driven path gates a wave of a frame that no cluster
holds, nor reaches a horizon past N≈3,300. On one card every stagewise
solve runs K5 (config 6's paths its shared variant, the long horizons and
the battery fleet its global one, the wide trees its grouped one and
the global one at S=64), K4's
sweep inside it, wherever K5 has an instantiation; past it (b above 128:
fleet_b160) and with the scenario axis over ranks the torch loop runs with
K4's sweep (the stagewise tree over ranks, phase 33) or K6's
(md_stagewise_tree_par, fleet_b160 and its twin). The L2-streamed K2 launches on the 4-agent
micro-grid only.

Every kernel result is held against its plain version field by field:
obj, x, z, y, r_prim, r_prim_rel and r_dual within LIMITS, certificate
bits identical (on the real frames of configs 2, 3 and 4b, they may
differ on instances near a threshold: CERT_BAND). Every phase draws its problems from a generator of its
own (``--seed N`` moves them all), so no phase's problems depend on what
ran before it. ``--readings`` runs the kernel phases alone (through phase
34), reads every field of every kernel comparison without stopping at the
first one off its limit, prints the largest reading of each regime, each
held probe's instances that round a relaxed binary otherwise and each
held certificate's differing bits, lists the fields off their limits and
exits 1 if there are any: it is how the limits are set, over seeds 0-7. Each kernel's line
carries its time at the shape the main path gives it -- ``ms`` around the
wrapper call (checks, allocation, launch), ``kernel_ms`` around the launch
alone -- its plain version's time and its bound: the larger of the
bytes it must move over the card's memory rate and its operations over
the card's peak rate for their type (NVIDIA H100 SXM data sheet).

Any failed check raises, so the script exits non-zero. It exits non-zero
without a result when no CUDA device is present or when the package is
missing beside it. The last lines are the closed loops' JSON, the card's
name and power limit, the kernels JSON and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCES = {"admm_k1": "pyhybridcontrol_tpu_torch/csrc/admm.cu",
           "admm_k2": "pyhybridcontrol_tpu_torch/csrc/admm.cu",
           "admm_k1_mixed": "pyhybridcontrol_tpu_torch/csrc/admm_mixed.cu",
           "admm_k1_resident": "pyhybridcontrol_tpu_torch/csrc/admm.cu",
           "admm_k2_resident": "pyhybridcontrol_tpu_torch/csrc/admm.cu",
           "admm_k1_streamed": "pyhybridcontrol_tpu_torch/csrc/admm.cu",
           "admm_k2_streamed": "pyhybridcontrol_tpu_torch/csrc/admm.cu",
           "admm_k1_split": "pyhybridcontrol_tpu_torch/csrc/admm.cu",
           "admm_k1_mixed_1pass":
               "pyhybridcontrol_tpu_torch/csrc/admm_mixed.cu",
           "admm_k1_split_1pass": "pyhybridcontrol_tpu_torch/csrc/admm.cu",
           "stagewise_k4": "pyhybridcontrol_tpu_torch/csrc/stagewise.cu",
           "stagewise_k5": "pyhybridcontrol_tpu_torch/csrc/stagewise.cu",
           "stagewise_k5_grouped":
               "pyhybridcontrol_tpu_torch/csrc/stagewise.cu",
           "stagewise_k5_global":
               "pyhybridcontrol_tpu_torch/csrc/stagewise.cu",
           "stagewise_k5_global_all":
               "pyhybridcontrol_tpu_torch/csrc/stagewise.cu",
           "stagewise_k5_horizon":
               "pyhybridcontrol_tpu_torch/csrc/stagewise.cu",
           "stagewise_k5_par": "pyhybridcontrol_tpu_torch/csrc/stagewise.cu",
           "stagewise_k5_grouped_par":
               "pyhybridcontrol_tpu_torch/csrc/stagewise.cu",
           "stagewise_k5_global_par":
               "pyhybridcontrol_tpu_torch/csrc/stagewise.cu",
           "stagewise_k5_global_all_par":
               "pyhybridcontrol_tpu_torch/csrc/stagewise.cu",
           "stagewise_k6": "pyhybridcontrol_tpu_torch/csrc/stagewise_any.cu"}
REPLACES = {"admm_k1": "pyhybridcontrol_tpu/ops/pallas_admm.py:312",
            "admm_k2": "pyhybridcontrol_tpu/ops/pallas_admm.py:357",
            "admm_k1_mixed": "pyhybridcontrol_tpu/ops/pallas_admm.py:180",
            "admm_k1_resident": "pyhybridcontrol_tpu/ops/pallas_admm.py:312",
            "admm_k2_resident": "pyhybridcontrol_tpu/ops/pallas_admm.py:357",
            "admm_k1_streamed": "pyhybridcontrol_tpu/ops/pallas_admm.py:312",
            "admm_k2_streamed": "pyhybridcontrol_tpu/ops/pallas_admm.py:357",
            "admm_k1_split": "pyhybridcontrol_tpu/ops/pallas_admm.py:180",
            # the one-pass split phase: the reference's "default" precision,
            # one bf16 MXU pass a product of its XLA iteration (BoxQP.precision)
            "admm_k1_mixed_1pass": "pyhybridcontrol_tpu/ops/admm.py:247",
            "admm_k1_split_1pass": "pyhybridcontrol_tpu/ops/admm.py:247",
            # K4 and K5 have no TPU kernel behind them: the reference's
            # sweep is the plain-XLA lax.scan pair of _solve_K, its
            # stagewise ADMM loop a plain-XLA fori_loop
            "stagewise_k4": "pyhybridcontrol_tpu/ops/stagewise.py:586",
            "stagewise_k5": "pyhybridcontrol_tpu/ops/stagewise.py:1011",
            # K5's FLEX variants: the same loop at the shapes the shared
            # variant cannot hold (more than 8 scenarios a group, a
            # scenario's state past a CTA's shared memory)
            "stagewise_k5_grouped": "pyhybridcontrol_tpu/ops/stagewise.py:1011",
            "stagewise_k5_global": "pyhybridcontrol_tpu/ops/stagewise.py:1011",
            "stagewise_k5_global_all":
                "pyhybridcontrol_tpu/ops/stagewise.py:1011",
            # the horizon variant: the same loop, a problem's horizon in
            # windows over a cluster; its parallel sweep also stands for
            # the reference's log-depth sweeps (_solve_K_assoc, :632)
            "stagewise_k5_horizon":
                "pyhybridcontrol_tpu/ops/stagewise.py:1011",
            # the parallel sweep inside the shared and FLEX variants: the
            # same loop with the reference's parallel_sweeps=True
            # (_solve_K_bordered over _solve_K_assoc, :650-664, :995)
            "stagewise_k5_par": "pyhybridcontrol_tpu/ops/stagewise.py:1011",
            "stagewise_k5_grouped_par":
                "pyhybridcontrol_tpu/ops/stagewise.py:1011",
            "stagewise_k5_global_par":
                "pyhybridcontrol_tpu/ops/stagewise.py:1011",
            "stagewise_k5_global_all_par":
                "pyhybridcontrol_tpu/ops/stagewise.py:1011",
            # K6, the sweep at any b (sequential: _solve_K, :586) and over
            # windows (for the reference's log-depth _solve_K_assoc, :632),
            # in the torch loop wherever K5 has no instantiation
            "stagewise_k6": "pyhybridcontrol_tpu/ops/stagewise.py:586,632"}
# K1 with the constants streamed from L2 in every iteration: the plan
# takes it only where a cluster cannot hold the constants (the 4-agent
# micro-grid's K2 waves do; no driven path gates a wave there),
# so it runs only where a phase forces it, to hold the resident variant
# against it; it must launch on no path. (K4, the standalone sweep, runs
# inside K5 on one card and on its own under a scenario mesh: the
# stagewise tree over ranks launches it once an iteration.)
# K5 with every scenario array in device memory takes horizons from about
# N=3,300 (b=5) on, which no path drives: phase 35 forces it.
FORCED_ONLY = ("admm_k1_streamed", "stagewise_k5_global_all",
               "stagewise_k5_global_all_par")
# the driven paths, in order; SERVED are the served requests
SERVED = ("serve_config1", "serve_batch_request", "config2_serve",
          "serve_stagewise")
PATHS = SERVED + ("pooled_bench_spec", "pooled_carried_incumbents",
                  "relax_sweep_low_frac", "closed_loop_config1",
                  "closed_loop_N27", "relax_sweep_N27_low_frac",
                  "config2_call", "config2b_call", "config2_sb_a",
                  "config2_sb_b", "config2_sb_c", "config2_sb_d",
                  "config2_sb_e", "config2_sb_f", "config2_cut",
                  "config3_loop",
                  "config4b_loop", "config4c_call", "config4c_feedback",
                  "config6_parity", "config6_long", "config6_long_par",
                  "stagewise_transforms",
                  "run_config1", "run_config3", "run_config2", "run_config4",
                  "run_config5", "run_checkpoint_resume", "microgrid_M3",
                  "microgrid_M4", "decentralized", "examples",
                  "md_config5_pool", "md_di_pool", "md_feedback_batch",
                  "md_condense", "md_consensus_tree", "md_stagewise_tree",
                  "md_nccl", "mixed_schedule", "long_horizon", "wide_tree",
                  "wide_tree_par", "battery_fleet", "battery_fleet_par",
                  "md_stagewise_tree_par", "fleet_b160", "fleet_b160_par")
# peak rates of one H100 SXM at 700 W (NVIDIA data sheet): fp32 outside
# the tensor cores, dense bf16 in them, HBM3
PEAK = dict(fp32=67e12, bf16=989e12, hbm=3.35e12)
SEED = 0
# Kernel vs plain version, both fp32 on the card: the sums run in another
# order (and the kernel fuses multiply-adds), so the iterates carry fp32
# noise, which grows with the iteration count. Error of a field: max over
# the batch of |Δ| / max(|ref|, FLOOR) — for the solution fields an
# absolute error where |ref| < 1 and a relative one above; for the
# residuals and K5's dual steps dy, dy_e (the certificate's inputs) an
# absolute error below 1e-3, the scale at which B&B reads them (feas_tol),
# and a relative one above (a swapped residual differs from the right one
# by a factor, not by an offset). Limits per regime:
# "main", the shapes of phases 2-3 (100-400 iterations), and "far",
# phase 4 (30 iterations).
FLOOR = dict(obj=1.0, x=1.0, z=1.0, y=1.0, z_e=1.0, y_e=1.0, r_prim=1e-3,
             r_prim_rel=1e-3, r_dual=1e-3, dy=1e-3, dy_e=1e-3)
# Limits: 3-5x the largest error of sound runs on an H100 over seeds 0-7
# (PERF.md has the readings, and the faults each regime catches). The
# split-precision phase: a last-bit difference of an operand can move its
# bf16 hi part by one step, so kernel and plain version differ at the
# 2^-17 level per product, not at fp32's 2^-24; the dual step multiplies
# that by ρ (up to 300 on boosted rows), and the iterates drift apart as
# the iterations go (y by 2e-2 after two). So the tensor-core kernel's own
# outputs are held after ONE iteration from the same warm iterates
# ("mixed_iterates"; a dropped bf16 pass reads 5e-2 and more on z there),
# and the whole solve (100-120 iterations, K1's tail and stats included)
# on objective and solution only ("mixed"): its residuals differ by 0.7
# and more on sound runs.
LIMITS = {
    "main": dict(obj=1.5e-4, x=4e-4, z=4e-4, y=1.5e-2, r_prim=0.2,
                 r_prim_rel=0.2, r_dual=4.0),
    "far": dict(obj=3e-5, x=2e-4, z=3e-4, y=8e-3, r_prim=3e-2,
                r_prim_rel=3e-2, r_dual=0.7),
    "mixed": dict(obj=1e-4, x=0.1),
    "mixed_iterates": dict(zG=3e-3, yG=8e-2, zB=3e-3, yB=1e-3),
    # the one-pass split phase (BoxQP.precision "default", the mixed
    # schedule's low_precision="default"; phase 34): each operand is
    # rounded to bf16 alone, so a last-bit difference of an operand moves
    # its product by a whole bf16 step (2^-9 relative, not the 2^-17 of
    # three passes), and 100 one-pass iterations wander within a noise
    # ball of O(1) in x: the plain version against itself after a one-ulp
    # change of q reads obj 3.54e-3, x 1.44 (tools/plain_noise.py
    # --one-pass, seeds 0-7, CPU; three passes: 3.10e-5, 5.77e-2). 3x the
    # largest kernel-vs-plain reading of seeds 0-7 on an H100 80GB HBM3 at
    # 700 W: the whole solve obj 4.86e-3, x 1.49; after one iteration zG
    # 1.32e-3, yG 3.41e-3, zB 1.32e-3, yB 1.19e-6 (the tight hold)
    "mixed_1pass": dict(obj=1.5e-2, x=4.5),
    "mixed_iterates_1pass": dict(zG=4e-3, yG=1.1e-2, zB=4e-3, yB=3.6e-6),
    # the double integrator at the staging cap and above (N=26-27): a
    # longer horizon is worse conditioned, so the same fp32 noise grows
    # more in 100-400 iterations (the plain version's own fp32-vs-fp64
    # difference: tests/test_torch_kernels.py::
    # test_fp32_noise_grows_with_the_horizon); 4x the "main" limits
    "large": dict(obj=6e-4, x=1.6e-3, z=1.6e-3, y=6e-2, r_prim=0.8,
                  r_prim_rel=0.8, r_dual=16.0),
    # the waves of configs 2, 3 and 4b (real frames; probes of 150-600
    # iterations at fixed binaries, whose rows bind as implied equalities):
    # the plain version's own probe is further from fp64 there — config 2:
    # x 1.3e-3 (2.4e-3 under a one-ulp change of q̂), y 1.9e-2; config 3:
    # r_dual 2.2 (2.4); config 4b: obj 1.2e-4 (4.3e-4), y 6.7e-3 — read on
    # the CPU at the same seeds; 3x those on obj, x and z. The residuals: 3x
    # the largest kernel-vs-plain reading of seeds 0-7 on an H100 80GB HBM3
    # at 700 W, r_prim 1.29e-2, r_dual 4.15 (were "large"'s 0.8 and 16),
    # where the plain version's own probes read up to 1.75e-2 and 4.20
    # (tools/plain_noise.py --paths, seeds 0-7, CPU)
    "wave_probe": dict(obj=1.3e-3, x=7e-3, z=7e-3, y=6e-2, r_prim=3.9e-2,
                       r_prim_rel=3.9e-2, r_dual=12.5),
    # K2's probes on the real frames with certificate rules at phase 9's
    # shapes (configs 2, 3, 4b; B = 1, 37, 300; 100 + 100 iterations, cold):
    # "main" but for the residuals, 3x the largest kernel-vs-plain reading of
    # seeds 0-7 on an H100 80GB HBM3 at 700 W: r_prim 5.33e-3, r_prim_rel
    # 6.77e-3, r_dual 5.8 (config 3, B=300, where "main"'s 4.0 refused
    # seeds 4 and 6; config 4b's B=300 read 5.16 at seed 7); the plain
    # version's own float32 against float64 there reads r_prim up to
    # 1.24e-2, r_dual up to 3.66 (tools/plain_noise.py --big-shapes, CPU)
    "real_probe": dict(obj=1.5e-4, x=4e-4, z=4e-4, y=1.5e-2, r_prim=2e-2,
                       r_prim_rel=2e-2, r_dual=18.0),
    # K4 against the plain sweeps (one solve, both fp32 summing each row in
    # column order; phase 20): 3.4x the largest reading of seeds 0-7 on an
    # H100, 1.79e-7 (tools/k4_readings.py)
    "sweep": dict(x=6e-7),
    # the same at the wide instantiations' random factors (b = 20-100:
    # longer rows, more rounding): 3x the largest reading of seeds 0-7,
    # 5.36e-7 at b=100
    "sweep_wide": dict(x=1.6e-6),
    # K5 against the plain loop (``_admm_iterations`` with the plain sweeps,
    # both fp32, summing in other orders; phase 22): the carries after a
    # whole relaxation or probe (150-200 iterations), cold and warm, at the
    # driven shapes (config 6's long arm, staged and not, and parity arm;
    # the served double integrator; the transforms hold); 3x the largest
    # reading of seeds 0-7 on an H100 (tools/k4_readings.py): x 5.6e-6, z
    # 7.87e-6, y 1.39e-4, dy 0.143, z_e 2.82e-5, y_e 1.15e-5, dy_e 1.25e-2
    "k5": dict(x=1.7e-5, z=2.4e-5, y=4.2e-4, dy=0.43, z_e=8.5e-5,
               y_e=3.5e-5, dy_e=3.8e-2),
    # the same at the wider blocks (the hull model, b=13; the double
    # integrator with a second force, b=6; staged and not): longer rows,
    # more rounding; x 1.28e-5, z 2.62e-5, y 3.33e-4, dy 0.25
    "k5_wide": dict(x=3.8e-5, z=7.9e-5, y=1e-3, dy=0.75),
    # at the soft state box, whose probe's dual step passes the soft prox's
    # division at ρ·10: x 1.17e-5, z 1.34e-5, y 1.14e-4, dy 0.763
    "k5_soft": dict(x=3.5e-5, z=4e-5, y=3.4e-4, dy=2.3),
    # at the infeasible wave, whose y grows every iteration (dy = y⁺ − y
    # carries y's rounding): x 1.55e-5, z 3.98e-5, y 1.72e-4, dy 1.83
    "k5_infeasible": dict(x=4.7e-5, z=1.2e-4, y=5.2e-4, dy=5.5),
    # K5's grouped and global-state variants against the plain loop (phase
    # 35): 20 iterations from the kernel's own relaxation at the
    # long_horizon and wide_tree paths' shapes (b=5: the double integrator
    # at N=1000, config 6's tree at S=16, 27, 64; "k5_flex_wide": the hull
    # model, b=13, N=300); 3x the largest reading of seeds 0-7 on an H100
    # 80GB HBM3 at 700 W (tools/k4_readings.py --flex): x 1.43e-6, z
    # 2.74e-6, y 9.54e-6, dy 1.53e-2, z_e 9.52e-6 / x 5.36e-6, z 1.06e-5,
    # y 3.34e-5, dy 8.76e-3, where the plain loop's own float32 against
    # float64, or against itself after a one-ulp change of q, reads up to x
    # 2.1e-6 / 3.2e-6, z 4.7e-6 / 7.9e-6, y 9.5e-6 / 2.5e-5, dy 1.5e-2 /
    # 7.5e-3, z_e 2.6e-5 (tools/plain_noise.py --flex, seeds 0-7, CPU).
    # y_e and dy_e read 0 (the budget row does not bind there): "k5"'s
    # limits
    "k5_flex": dict(x=4.3e-6, z=8.2e-6, y=2.9e-5, dy=4.6e-2, z_e=2.9e-5,
                    y_e=3.5e-5, dy_e=3.8e-2),
    "k5_flex_wide": dict(x=1.6e-5, z=3.2e-5, y=1e-4, dy=2.6e-2),
    # K5's horizon variant in its parallel sweep against its plain version
    # (the plain loop with _solve_K_windowed on the plan's windows), 20
    # iterations from the sequential relaxation at the long_horizon waves
    # ("_wide": the hull model, b=13); 3x the largest reading of seeds 0-7
    # on an H100 80GB HBM3 at 700 W (tools/k4_readings.py --flex): x
    # 8.94e-7, z 1.25e-6, y 5.72e-6, dy 1.34e-2 / x 4.74e-6, z 8.31e-6, y
    # 3.28e-5, dy 5.72e-3 (the plain loop's own fp32-vs-fp64 spread there,
    # tools/plain_noise.py --flex, seeds 0-7: x up to 8.3e-7 / 2.9e-6)
    "k5_horizon_par": dict(x=2.7e-6, z=3.8e-6, y=1.7e-5, dy=4.0e-2),
    "k5_horizon_par_wide": dict(x=1.4e-5, z=2.5e-5, y=9.8e-5, dy=1.7e-2),
    # K5 past its register path against the plain loop (phase 37): 20
    # iterations from the kernel's own relaxation; 3x the largest reading
    # of seeds 0-7 on an H100 80GB HBM3 at 700 W (tools/k4_readings.py
    # --any). "k5_any": bmax 32 to 128 (the battery fleets at b = 20, 32,
    # 64, 128; the ω double integrators' tree at b = 20): x 2.55e-5, z
    # 8.80e-5, y 3.24e-5, dy 4.58e-2, z_e 1.84e-4, where the plain loop's
    # own float32 against float64, or against itself after a one-ulp
    # change of q, reads up to x 2.2e-5, z 9.1e-5, y 3.3e-5, dy 3.1e-2, z_e
    # 3.5e-4 (tools/plain_noise.py --any, seeds 0-7, CPU); y_e and dy_e
    # read 0 there (no budget row binds): "k5"'s limits. "k5_rt": b = 5
    # with 5, 20 and 300 extra rows (config 6's long arm): x 1.91e-6, z
    # 2.50e-6, y 8.05e-6, dy 1.91e-2, z_e 2.80e-6, y_e 2.53e-6, dy_e
    # 9.54e-4, the plain loop's own up to x 1.4e-6, z 2.1e-6, y 8.3e-6, dy
    # 1.3e-2, z_e 3.2e-6, y_e 2.0e-6, dy_e 9.8e-4
    "k5_any": dict(x=7.7e-5, z=2.7e-4, y=9.8e-5, dy=0.14, z_e=5.6e-4,
                   y_e=3.5e-5, dy_e=3.8e-2),
    # K5's parallel sweep inside the shared and FLEX variants against its
    # plain version (the plain loop with _solve_K_windowed on the plan's
    # windows; phase 39): 20 iterations from the sequential relaxation;
    # 3x the largest reading of seeds 0-7 on an H100 80GB HBM3 at 700 W
    # (tools/k4_readings.py --par), each prep in a regime of its own: the
    # probes' ρ·10 prep carries ten times the rounding of the relaxation's
    # in its dual steps. "k5_par" (b=5, the relaxation's prep: config 6's
    # long arm, also forced grouped/global/global_all; the wide trees): x
    # 1.98e-6, z 2.56e-6, y 9.54e-6, dy 1.53e-2, z_e 1.04e-5;
    # "k5_par_probe" (config 6's long arm at ρ·10): x 1.49e-6, z 2.31e-6,
    # y 7.45e-5, dy 0.119, z_e 6.50e-6; "k5_par_rt" (5 extra rows): x
    # 1.04e-6, z 1.97e-6, y 6.56e-6, dy 1.19e-2, z_e 2.15e-6; "k5_par_any"
    # (b > 16 at the relaxation's prep: the fleet, b=32; 32 batteries,
    # b=128; held only, staged at b=20: five batteries and the ω tree): x
    # 2.50e-5, z 8.88e-5, y 4.34e-5, dy 3.81e-2, z_e 2.77e-4;
    # "k5_par_any_probe" (the fleet at ρ·10): x 1.31e-5, z 1.48e-5, y
    # 6.68e-5, dy 0.244, z_e 1.26e-4. y_e and dy_e read 0 (no budget row
    # binds): "k5"'s and "k5_rt"'s limits
    "k5_par": dict(x=6e-6, z=7.7e-6, y=2.9e-5, dy=4.6e-2, z_e=3.2e-5,
                   y_e=3.5e-5, dy_e=3.8e-2),
    "k5_par_probe": dict(x=4.5e-6, z=7e-6, y=2.3e-4, dy=0.36, z_e=2e-5,
                         y_e=3.5e-5, dy_e=3.8e-2),
    "k5_par_rt": dict(x=3.2e-6, z=6e-6, y=2e-5, dy=3.6e-2, z_e=6.5e-6,
                      y_e=7.6e-6, dy_e=2.9e-3),
    "k5_par_any": dict(x=7.5e-5, z=2.7e-4, y=1.3e-4, dy=0.12, z_e=8.4e-4,
                       y_e=3.5e-5, dy_e=3.8e-2),
    "k5_par_any_probe": dict(x=4e-5, z=4.5e-5, y=2.1e-4, dy=0.74,
                             z_e=3.8e-4, y_e=3.5e-5, dy_e=3.8e-2),
    # the shapes of PAR_SMALL (windows of one or two stages, every row
    # kind, b = 6 and 13), 3x the largest reading of seeds 0-7 (the same
    # tool): x 8.36e-6, z 1.02e-5, y 3.16e-5, dy 7.63e-2 (the soft state
    # box's prox at most), z_e 8.94e-7, y_e 5.96e-7, dy_e 6.56e-4 (the
    # transforms hold's budget row)
    "k5_par_small": dict(x=2.5e-5, z=3.1e-5, y=9.5e-5, dy=0.23, z_e=2.7e-6,
                         y_e=1.8e-6, dy_e=2e-3),
    "k5_rt": dict(x=5.8e-6, z=7.5e-6, y=2.5e-5, dy=5.8e-2, z_e=8.4e-6,
                  y_e=7.6e-6, dy_e=2.9e-3),
    # K6 against its plain versions (``_solve_K`` for one window,
    # ``_solve_K_windowed`` over ``any_windows(N)``; phase "K6 vs plain"),
    # 3x the largest reading of seeds 0-7 on an H100 80GB HBM3 at 700 W
    # (tools/k4_readings.py --k6): "k6" at the preps' factors (config 6's
    # long arm, b=5; the fleets, b=32, 128 and 160), x 7.75e-7; "k6_random"
    # at random factors (b=129, 137, 256; longer rows), x 1.85e-6
    "k6": dict(x=2.4e-6),
    "k6_random": dict(x=5.6e-6),
    # K2 at the surfaces' waves (phase 23), relaxation and probe, 3x the
    # largest reading of seeds 0-7 on an H100 (tools/surface_readings.py):
    # the micro-grid coordinator's aggregate frames (3 and 4 agents, N=24;
    # the 4-agent one L2-streamed): obj 1.30e-3, x 4.23e-4, z 1.04e-3, y
    # 4.21e-2, r_prim 3.83e-2, r_prim_rel 9.25e-5, r_dual 1.09
    "microgrid": dict(obj=3.9e-3, x=1.3e-3, z=3.1e-3, y=0.13, r_prim=0.12,
                      r_prim_rel=2.8e-4, r_dual=3.3),
    # the decentralized agents' wave and config 5's global wave (N=20,
    # 300 + 300 iterations): obj 2.34e-4, x 2.07e-4, z 3.03e-4, y 1.83e-2,
    # r_prim and r_prim_rel 0.107, r_dual 9.98
    "surfaces": dict(obj=7e-4, x=6.2e-4, z=9.1e-4, y=5.5e-2, r_prim=0.32,
                     r_prim_rel=0.32, r_dual=30.0),
    # K2 at the multi-device phase's per-rank waves (phase 32), 3x the
    # largest reading of seeds 0-7 on an H100 80GB HBM3 at 700 W
    # (tools/surface_readings.py --md): config 5's pool wave (the PWA
    # spring, N=14, B=256, 300 + 300 iterations), its relaxation: obj
    # 2.25e-5, x 2.05e-4, z 2.04e-4, y 1.36e-3, r_prim 8.91e-5, r_prim_rel
    # 1.04e-4, r_dual 9.13e-5 ("main" holds x and z at under 2x that; its
    # probe is held at "wave_probe")
    "md_pool": dict(obj=6.8e-5, x=6.2e-4, z=6.2e-4, y=4.1e-3,
                    r_prim=2.7e-4, r_prim_rel=3.2e-4, r_dual=2.8e-4),
    # the feedback_batch(mesh=) slice (N=20, B=1024, 300 + 300),
    # relaxation and probe: obj 4.03e-5, x 1.34e-4, z 2.52e-4, y 2.55e-2
    # (the probe; "surfaces" would hold it at about 2x), r_prim and
    # r_prim_rel 5.34e-2, r_dual 3.70
    "md_slice": dict(obj=1.3e-4, x=4.1e-4, z=7.6e-4, y=7.7e-2, r_prim=0.17,
                     r_prim_rel=0.17, r_dual=12.0),
    # K1 at root strong branching's batch (config 2's 120 candidate
    # children, 400 iterations warm from the root), 3x the largest reading
    # of seeds 0-7 on an H100 (tools/sb_readings.py): obj 2.94e-6, x
    # 3.57e-4, z 3.58e-4, y 2.67e-3, r_prim and r_prim_rel 3.56e-4, r_dual
    # 2.52e-3 — the plain version's own fp32-vs-fp64 there: x 3.4e-4, y
    # 3.2e-3, r_dual 2.2e-3 (tools/plain_noise.py --strong-branching)
    "strong_branching": dict(obj=9e-6, x=1.1e-3, z=1.1e-3, y=8e-3,
                             r_prim=1.1e-3, r_prim_rel=1.1e-3, r_dual=7.6e-3),
    # device condensation (ops/condense_scan.py) against the host fp64
    # build, error relative to max |ref| per operator (config 6's model at
    # N=120 reads 0: its matrices are exact in fp32; the 64 DEWH variants
    # at N=24 set these) and the N=120 rollout (xs): 3x the largest
    # reading of seeds 0-7 on an H100 (tools/sb_readings.py), 5.70e-7,
    # 5.33e-7, 5.28e-7, 4.04e-7, 5.16e-7, 5.33e-7, 5.11e-7, 3.17e-7, 1.27e-6
    "condense": dict(Phi=1.7e-6, Gv=1.6e-6, Gw=1.6e-6, Gc=1.2e-6,
                     Phi_t=1.5e-6, Gv_t=1.6e-6, Gw_t=1.5e-6, Gc_t=9.5e-7,
                     xs=3.8e-6),
}
# the iterate check starts from the plain version's iterates after these
# many split-precision iterations
MIXED_WARM = (10, 50)
MIXED_GATE = 1e-4   # max relative objective delta, low_frac=1.0 vs full K1
# |obj(B&B) − obj(enumeration)| ≤ max(1e-3, SERVE_STEPS·2⁻²³·|obj|): the
# objectives are fp32, so above |obj| ≈ 44 the limit follows fp32's
# resolution. SERVE_STEPS is ~3× the largest reading above the floor of
# sound runs over seeds 0-7, in units of 2⁻²³·|obj|: 66.6 of them, 1.94e-3 at
# obj −243.9 (PERF.md has the readings). B&B solves its nodes with 100
# ADMM iterations, enumeration with 600, so the two objectives differ by
# more than rounding.
SERVE_FLOOR = 1e-3
SERVE_STEPS = 192
BATCH = 1024        # config 4: instances of one batched request
BATCH_SAMPLE = tuple(range(0, BATCH, 16))   # 64 instances held to enumeration
BATCH_OUT_OF_BOX = 5                        # instance replaced by OUT_OF_BOX
STATES = ([2.0, 0.0], [-3.0, 1.0], [5.0, -1.0], [0.5, 0.5])
OUT_OF_BOX = [12.0, 0.0]   # |x| ≤ 10 box of the double integrator
FAR_ITERS = 30             # far from convergence at config 1
FAR_BATCHES = (1, 3, 32, 33, 257)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def serve_limit(obj_ref):
    """Limit on |obj − obj_ref| of a served objective (scalar or array)."""
    import numpy as np

    return np.maximum(SERVE_FLOOR,
                      SERVE_STEPS * 2.0 ** -23 * np.abs(obj_ref))


def serve_reading(tag, d, obj_ref):
    """Print the worst |Δobj| of a serve phase (largest share of its limit)
    with its objective, in units of 2⁻²³·|obj|, and its limit; raise if it
    is over."""
    import numpy as np

    d, obj_ref = np.atleast_1d(d), np.atleast_1d(obj_ref)
    lim = serve_limit(obj_ref)
    i = int(np.argmax(d / lim))
    steps = d[i] / (2.0 ** -23 * max(abs(obj_ref[i]), 1e-30))
    print(f"  {tag}: worst |Δobj| {d[i]:.2e} at obj {obj_ref[i]:.1f} "
          f"({steps:.1f} × 2⁻²³·|obj|), limit {lim[i]:.2e}", flush=True)
    check(d[i] <= lim[i], f"{tag}: |Δobj|={d[i]:.3e} at obj "
          f"{obj_ref[i]:.1f}, limit {lim[i]:.3e}")


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5):
    """Median CUDA-event time of fn() in ms (after one warmup call)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


KERNEL_FUNCTIONS = (("admm", "phc_admm_k1"), ("admm", "phc_admm_k1_1pass"),
                    ("admm", "phc_admm_k2"),
                    ("admm_mixed", "phc_admm_k1_mixed"),
                    ("admm_mixed", "phc_admm_k1_mixed_1pass"),
                    ("stagewise", "phc_sw_solve_k"),
                    ("stagewise", "phc_sw_admm"),
                    ("stagewise", "phc_sw_admm_flex"),
                    ("stagewise_wide", "phc_sw_admm"),
                    ("stagewise_wide", "phc_sw_admm_flex"),
                    ("stagewise_extra", "phc_sw_admm"),
                    ("stagewise_extra", "phc_sw_admm_flex"),
                    ("stagewise_horizon", "phc_sw_admm_horizon"),
                    ("stagewise_par", "phc_sw_admm"),
                    ("stagewise_par", "phc_sw_admm_flex"),
                    ("stagewise_wide_par", "phc_sw_admm"),
                    ("stagewise_wide_par", "phc_sw_admm_flex"),
                    ("stagewise_extra_par", "phc_sw_admm"),
                    ("stagewise_extra_par", "phc_sw_admm_flex"),
                    ("stagewise_any", "phc_sw_solve_k_any"))


def kernel_ms(fn, reps=5):
    """Median over ``reps`` calls of fn() of the time of the kernel
    launches inside it alone: CUDA events recorded just before and after
    each call into the kernel library, summed per fn() (after one warmup
    call)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import _build

    pairs = []

    def shim(orig):
        def call(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            rc = orig(*a)
            e1.record()
            pairs.append((e0, e1))
            return rc
        return call

    saved = [(_build.load_library(lib), name) for lib, name in
             KERNEL_FUNCTIONS if lib in _build.LIBRARIES]
    saved = [(lib, name, getattr(lib, name)) for lib, name in saved]
    fn()
    for lib, name, orig in saved:
        setattr(lib, name, shim(orig))
    try:
        times = []
        for _ in range(reps):
            pairs.clear()
            fn()
            torch.cuda.synchronize()
            times.append(sum(a.elapsed_time(b) for a, b in pairs))
    finally:
        for lib, name, orig in saved:
            setattr(lib, name, orig)
    return sorted(times)[len(times) // 2]


def admm_work(nr, mGp, B, products, stats, warm, stiff=False, lo_products=0,
              outputs=1, lo_passes=3):
    """(bytes, {type: operations}) of a batched σ=0 ADMM kernel call, from
    its shapes: each input read once, each output written once; one
    product pair (Â_Gᵀw, M t) is 2·(mGp·nr + (mGp+nr)·nr) operations per
    problem, a stats block 2·nr² + 4·mGp·nr. ``lo_products`` of the
    products are ``lo_passes``-pass bf16 (tensor cores; one pass reads the
    hi constants alone)."""
    R = mGp + nr
    per_problem_in = 3 * nr + 2 * mGp + (2 * R if warm else 0)
    per_problem_out = outputs * (3 * nr + 2 * mGp + 8)
    consts = mGp * nr + nr * R + nr * nr + 6 * nr + 3 * mGp
    if stiff:
        consts += nr * R + 6 * nr + 3 * mGp + nr
    if lo_products:
        # bf16 hi/lo pairs: 2 × 2 bytes an element; hi alone: 2 bytes
        consts += (mGp * nr + nr * R) * (1 if lo_passes == 3 else 0.5)
    pair = 2 * (mGp * nr + R * nr)
    ops = dict(fp32=B * (products * pair
                         + stats * (2 * nr * nr + 4 * mGp * nr)))
    if lo_products:
        ops["bf16"] = B * lo_products * lo_passes * pair
    return 4 * (B * (per_problem_in + per_problem_out) + consts), ops


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type (the units work side by
    side, so the slowest of them bounds, not their sum)."""
    t_bytes = nbytes / PEAK["hbm"]
    t_ops = max(v / PEAK[k] for k, v in ops.items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def chain_ms(nr, mGp, iterations):
    """Reckoned floor of ONE problem's dependent iteration chain in K1/K2
    with one problem per block (what bounds a batch too small to fill the
    card, where the roofline bound says nothing): per iteration the serial
    FMA chains of the two products — mGp/8 and nr/2 FMAs at 4 cycles each —
    their 3 + 1 shuffle steps of ~25 cycles, two shared-memory load
    latencies of ~30 cycles and two block-wide barriers of ~20 cycles, at
    the 1.98 GHz boost clock. The latencies are assumed round figures, not
    measured."""
    cycles = 4 * (mGp // 8 + nr // 2) + 4 * 25 + 2 * 30 + 2 * 20
    return 1e3 * iterations * cycles / 1.98e9


def set_bound(rec, kq, B, **kw):
    rec["bound_ms"], rec["bound_by"] = bound(
        *admm_work(kq.n_pad, kq.m_pad, B, **kw))
    # no single PyTorch call computes a batch of ADMM solves
    rec["library_ms"] = None


def problem(N, B, dev, rng, fix_frac=0.0):
    """Double integrator at horizon N: prepared specs and a batch of B
    seeded states; with fix_frac>0 each problem fixes that fraction of its
    binaries at random (B&B-node boxes)."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.models import (
        di_default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc

    c = CondensedMpc(switched_double_integrator(), N, di_default_weights())
    qp = c.device_qp(dev)
    spec = prepare_admm_mpc(c, device=dev)
    spec_p = prepare_admm_mpc(c, rho=10.0, device=dev)
    x0s = torch.as_tensor(rng.normal(size=(B, 2)).astype(np.float32),
                          device=dev)
    f, h = qp.assemble(x0s)
    lb, ub = node_boxes(qp, B, rng, fix_frac)
    return c, qp, spec, spec_p, f, h, lb, ub


def node_boxes(qp, B, rng, fix_frac, groups=None):
    """(B, n) box bounds of B&B nodes of ``qp``: each fixes ``fix_frac`` of
    its binaries at random (none with fix_frac=0); with ``groups`` (the
    group id of each binary) it fixes that fraction of the groups, each
    to one value for all its members."""
    import numpy as np
    import torch

    dev = qp.lb.device
    lb = qp.lb.expand(B, qp.n).clone()
    ub = qp.ub.expand(B, qp.n).clone()
    if fix_frac > 0:
        ng = qp.n_binary if groups is None else int(max(groups)) + 1
        fm = rng.uniform(size=(B, ng)) < fix_frac
        fv = (rng.uniform(size=(B, ng)) < 0.5).astype(np.float32)
        if groups is not None:
            fm, fv = fm[:, groups], fv[:, groups]
        bidx = torch.as_tensor(qp.binary_idx, device=dev)
        fm_t = torch.as_tensor(fm, device=dev)
        fv_t = torch.as_tensor(fv, device=dev)
        lb[:, bidx] = torch.where(fm_t, fv_t, 0.0)
        ub[:, bidx] = torch.where(fm_t, fv_t, 1.0)
    return lb, ub


def phase_rng(name):
    """Generator of one phase's problems, seeded by SEED and the phase's
    name: adding a phase or a shape elsewhere changes no other phase's
    problems."""
    import numpy as np

    return np.random.default_rng([SEED, *name.encode()])


def held(tag, regime, pairs):
    """Each (got, ref) pair of ``pairs`` within its limit of the regime:
    error = max |Δ| / max(|ref|, floor)."""
    import torch

    limits, seen = LIMITS[regime], READINGS.setdefault(regime, {})
    errs = {}
    for k, (g, r) in pairs.items():
        check(bool(torch.isfinite(g).all()), f"{tag}: non-finite {k}")
        errs[k] = float(((g - r).abs()
                         / torch.clamp_min(r.abs(), FLOOR.get(k, 1.0))).max())
        seen[k] = max(seen.get(k, 0.0), errs[k])
    print(f"  {tag}: " + " ".join(f"{k}={v:.2e}" for k, v in errs.items()),
          flush=True)
    for k, v in errs.items():
        if v > limits[k] and READINGS_ONLY:
            OVER.append(f"{tag}: {k} off by {v:.3e}, limit {limits[k]:.1e}")
            continue
        check(v <= limits[k], f"{tag}: {k} off by {v:.3e}, limit "
              f"{limits[k]:.1e}")


# The infeasibility certificate (ops/admm.py) is three threshold tests on the
# last dual step: ‖Âᵀδy‖∞ and the support sum at most 1e-4·‖δy‖∞, the gap
# sum at most −1e-4·‖δy‖∞. Âᵀδy ≈ 0 is a cancellation, so those ratios carry
# fp32 noise of their own size: the plain version in fp32 and in fp64 differ
# by up to 3.6x in ‖Âᵀδy‖∞/‖δy‖∞ on config 3's node probes (B=300 of phase
# 9: 49 instances have a ratio within 4x of its threshold; the bits agree).
# Kernel and plain version give the same bits (compare), except on the real
# frames of configs 2, 3 and 4b, where a reading showed the need (config
# 4b's waves: up to 48 of 1023 probe bits): there they may differ only on
# instances whose plain ratio lies within a factor CERT_BAND of its
# threshold, at most CERT_SHARE of a batch (cert_near).
CERT_EPS = 1e-4
CERT_BAND = 4.0
CERT_SHARE = 0.12
# The decentralized agents' wave (phase 23; DEWH at N=8, soft band, about
# half of the nodes infeasible) reads kernel-vs-plain certificate bits
# that differ where the plain ratio ‖Âᵀδy‖∞/‖δy‖∞ lies 6.5x and 8.5x below
# its threshold (seeds 3 and 2 of 0-7, one bit each; the kernel's final
# iterates put the same ratio 4x and 1.3x above it): 3x the largest
# reading, there only
CERT_BAND_DEC = 26.0
# Config 3's loop wave (B=64, 200 + 200; phase 9): kernel and plain version
# differ in a probe's certificate bit on an instance whose plain ratio lies
# 4.69x from its threshold (seed 5 of 0-7; the others within 1.65x), where
# the plain version's own float32 against float64 differs within 3.18x
# (tools/plain_noise.py --paths): 3x the largest reading, there only
CERT_BAND_CFG3 = 14.0


@contextlib.contextmanager
def cert_band(band):
    """CERT_BAND set to ``band`` inside the block."""
    global CERT_BAND
    saved, CERT_BAND = CERT_BAND, band
    try:
        yield
    finally:
        CERT_BAND = saved


def cert_near(plain, ref, binary_idx=None):
    """(B,) mask of the instances of the plain version's result ``ref``
    whose certificate ratios lie within CERT_BAND of a threshold
    (``cert_factor``)."""
    return cert_factor(plain, ref, binary_idx) <= CERT_BAND


def cert_factor(plain, ref, binary_idx=None):
    """(B,) factor within which the certificate ratios of each instance of
    the plain version's result ``ref`` lie of their threshold: the least
    over the three ratios of max(r/ε, ε/r) (infinite where no ratio is
    positive). ``plain`` is the plain call's (kq, q, h, lb, ub): its last
    half step runs again from ref's final iterates, which gives the
    certificate's inputs (a K2 probe: ``binary_idx``, whose iterates sit
    at their probe values, fix the probe's box). Checks that these inputs
    give ref's bits back away from the thresholds (CERT_BAND)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    kq, q, h, lb, ub = plain
    qs, lG, uG, lB, uB, (zG, yG, zB, yB) = ca._pack(
        kq, q, h, lb, ub, (ref.x, ref.z, ref.y))
    if binary_idx is not None:
        fixed = ca._binaries(kq, binary_idx)[1] > 0
        lB, uB = torch.where(fixed, zB, lB), torch.where(fixed, zB, uB)
    *_, dyG, dyB = ca._phase(
        qs, lG, uG, lB, uB, kq.AGT, kq.M, kq.dbox, kq.rhoG, kq.rhoG_inv,
        kq.rhoB, kq.rhoB_inv, zG, yG, zB, yB, 0, kq.base.alpha)
    dy, l, u = (torch.cat(p, -1) for p in ((dyG, dyB), (lG, lB), (uG, uB)))
    Atdy = (dyG @ kq.AGT.T + kq.dbox * dyB).abs().amax(-1)
    dn = dy.abs().amax(dim=-1).double().clamp_min(1e-300)
    dyp = torch.clamp_min(dy, 0.0).double()
    dyn = torch.clamp_max(dy, 0.0).double()
    fin_u, fin_l = u < 0.9e30, l > -0.9e30
    factor = torch.full(ref.infeas_cert.shape, float("inf"),
                        dtype=torch.float64, device=dy.device)
    for r in (Atdy.double() / dn,
              (torch.where(~fin_u, dyp, 0.0).sum(-1)
               + torch.where(~fin_l, -dyn, 0.0).sum(-1)) / dn,
              -(torch.where(fin_u, u.double() * dyp, 0.0).sum(-1)
                + torch.where(fin_l, l.double() * dyn, 0.0).sum(-1)) / dn):
        pos = r > 0
        f = torch.where(pos, torch.maximum(r / CERT_EPS, CERT_EPS / r.where(
            pos, 1.0)), float("inf"))
        factor = torch.minimum(factor, f)
    bits = ca.infeasibility_certificate(dy, Atdy, l, u)
    check(not bool(((bits != ref.infeas_cert) & (factor > CERT_BAND)).any()),
          "cert_near: the plain version's last half step, run again, "
          "gives other certificate bits")
    return factor


def certs_held(tag, got, ref, near=None):
    """The kernel's certificate bits equal to the plain version's; with
    ``near`` (a callable giving cert_factor's factors, or a mask), they
    may differ on instances near a threshold (CERT_BAND, CERT_SHARE)."""
    import torch

    if near is None:
        same = torch.equal(got.infeas_cert, ref.infeas_cert)
        what = f"{tag}: infeasibility certificate bits differ"
        if READINGS_ONLY and not same:
            OVER.append(what)
        else:
            check(same, what)
        return
    differ = got.infeas_cert != ref.infeas_cert
    if not bool(differ.any()):
        return
    near = near()
    far = float("nan")
    if near.dtype != torch.bool:
        far = float(near[differ].max())      # the farthest differing bit
        near = near <= CERT_BAND
    n = int(differ.sum())
    CERT_READINGS.append((tag, n, int((differ & near).sum()),
                          differ.numel(), far))
    print(f"  {tag}: {n} of {differ.numel()} certificate bits differ "
          f"(the farthest within {far:.3g}x of its threshold), "
          f"{int((differ & near).sum())} on instances whose plain ratios "
          f"lie within {CERT_BAND:g}x of their threshold", flush=True)
    ok = bool(near[differ].all()) and n <= max(1, CERT_SHARE
                                                 * differ.numel())
    what = (f"{tag}: infeasibility certificate bits differ ({n}, "
            f"{int((differ & ~near).sum())} away from the thresholds)")
    if READINGS_ONLY and not ok:
        OVER.append(what)
    else:
        check(ok, what)


def compare(tag, got, ref, record, regime="main", near=None):
    """Kernel result vs plain result (AdmmResult), on every field the
    regime has a limit for; raises if a field is off its limit or the
    certificate bits differ (certs_held: with ``near``, a callable giving
    cert_near's mask, they may differ near a threshold)."""
    held(tag + f" certs={int(got.infeas_cert.sum())}", regime,
         {k: (getattr(got, k), getattr(ref, k)) for k in LIMITS[regime]})
    certs_held(tag, got, ref, near)
    record["max_abs_err"] = max(record.get("max_abs_err", 0.0),
                                float((got.obj - ref.obj).abs().max()),
                                float((got.x - ref.x).abs().max()))


# K2's probe fixes every binary to the ROUNDED relaxation, so where a
# relaxed binary lies within fp32 noise of 0.5 the kernel and the plain
# version may round it to different sides and then solve different probes.
# Such instances are left out of the probe comparison, and held instead to:
# at most FLIP_SHARE of the batch, and every binary rounded differently
# within FLIP_BAND of 0.5 in the plain version's relaxation.
FLIP_SHARE = 2e-3
FLIP_BAND = 2e-3
# The hull encoding of config 2 puts region binaries at 0.5 wherever a state
# lies on a guard boundary, so its waves hold many such binaries: 6 of 128
# instances of the config-2 wave rounded one differently (each within 4.1e-6
# of 0.5). Its share is 3x that reading.
FLIP_SHARE_HULL = 0.15
# Config 4b's pooled wave (B=1024, 150 + 150; phase 9): kernel and plain
# version round a relaxed binary otherwise on 1 to 6 of 1024 instances over
# seeds 0-7 (each within 3.7e-6 of 0.5), where the plain version's own
# float32 against float64 does on 1 to 5 (within 4.7e-6; tools/plain_noise.py
# --config4b, CPU): 3x the largest reading, at this wave only
FLIP_SHARE_4B = 0.018
# The decentralized agents' wave rounds a relaxed binary otherwise than the
# plain version on 2 of 128 instances (seeds 3 and 4 of 0-7, each within
# 2.4e-6 of 0.5; the plain version's own fp32-vs-fp64 rounding differs on
# up to 3 of 128, tools/plain_noise.py --decentralized): 3x that reading
FLIP_SHARE_DEC = 0.047


def compare_probe(tag, got, ref, qp, lb, ub, record, regime="main",
                  flip_share=FLIP_SHARE, probe_regime=None, plain=None):
    """K2's (relax, probe) against the plain version's: the relaxation on
    every instance (limits of ``regime``), the probe on the instances whose
    binaries both rounded the same way (see FLIP_SHARE; limits of
    ``probe_regime``, by default ``regime``). With ``plain``, the plain
    call's (kq, q, h, lb, ub), certificate bits may differ near a threshold
    (cert_near)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops.admm import AdmmResult

    compare(tag + " relax", got[0], ref[0], record, regime,
            None if plain is None else lambda: cert_factor(plain, ref[0]))
    bidx = torch.as_tensor(qp.binary_idx, device=lb.device)

    def rounded(res):
        return torch.round(torch.clamp(torch.clamp(
            res.x[:, bidx], lb[:, bidx], ub[:, bidx]), 0.0, 1.0))

    differ = rounded(got[0]) != rounded(ref[0])
    same = ~differ.any(-1)
    flips = int((~same).sum())
    off = (float((ref[0].x[:, bidx][differ] - 0.5).abs().max()) if flips
           else 0.0)
    FLIP_READINGS.append((tag, flips, same.numel(), off, flip_share))
    if flips:
        print(f"  {tag}: {flips} of {same.numel()} instances round a "
              f"relaxed binary within {off:.1e} of 0.5 to the other side; "
              f"probe held on the rest", flush=True)
        for ok, what in (
                (flips <= max(1, flip_share * same.numel()),
                 f"{tag}: {flips} instances with probe bounds that differ"),
                (off <= FLIP_BAND, f"{tag}: a binary {off:.2e} from 0.5 "
                 f"was rounded differently")):
            if READINGS_ONLY and not ok:
                OVER.append(what)
            else:
                check(ok, what)
    got_p, ref_p = (AdmmResult(**{k: None if v is None else v[same]
                                  for k, v in vars(r).items()})
                    for r in (got[1], ref[1]))
    compare(tag + " probe", got_p, ref_p, record, probe_regime or regime,
            None if plain is None
            else lambda: cert_factor(plain, ref[1], qp.binary_idx)[same])


READINGS = {}   # largest error per regime and field over the run
# per held probe: (tag, instances rounding a binary otherwise, batch, the
# farthest of those binaries from 0.5, the share allowed); per held
# certificate: (tag, bits that differ, of those near a threshold, batch,
# the factor within which the farthest of them lies of its threshold)
FLIP_READINGS = []
CERT_READINGS = []
# --readings: a field off its limit is listed in OVER instead of stopping
# the run, so that one run reads every field (the run then fails at its end)
READINGS_ONLY = False
OVER = []


def phase_k1(dev, rng, rec):
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm
    from pyhybridcontrol_tpu_torch.solver.enumerate import _all_assignments

    print("K1 (admm_k1) vs plain:", flush=True)
    # config 1's enumeration batch: all 2^10 gear sequences of one state
    c, qp, spec, _, f, h, lb, ub = problem(10, 1, dev, rng)
    asg = torch.as_tensor(_all_assignments(qp.n_binary), device=dev)
    B = asg.shape[0]
    bidx = torch.as_tensor(qp.binary_idx, device=dev)
    lb = qp.lb.expand(B, qp.n).clone()
    ub = qp.ub.expand(B, qp.n).clone()
    lb[:, bidx] = asg
    ub[:, bidx] = asg
    args = (ca.kernel_qp_for(spec), f.expand(B, -1).contiguous(),
            h.expand(B, -1).contiguous(), lb, ub)
    got = ca.admm_solve_cuda(*args, iters=400)
    ref = ca.admm_solve_plain(*args, iters=400)
    compare("N=10 B=1024 400 it", got, ref, rec)
    rec["enum_ms"] = cuda_ms(lambda: ca.admm_solve_cuda(*args, iters=400))
    rec["enum_kernel_ms"] = kernel_ms(
        lambda: ca.admm_solve_cuda(*args, iters=400))
    rec["enum_plain_ms"] = cuda_ms(
        lambda: ca.admm_solve_plain(*args, iters=400))
    rec["enum_bound_ms"] = bound(*admm_work(
        args[0].n_pad, args[0].m_pad, B, products=401, stats=1,
        warm=False))[0]
    print(f"  N=10 B=1024 400 it: wrapper {rec['enum_ms']:.3f} ms, kernel "
          f"alone {rec['enum_kernel_ms']:.3f} ms, plain "
          f"{rec['enum_plain_ms']:.3f} ms, bound {rec['enum_bound_ms']:.4f} "
          f"ms", flush=True)

    # the shape batched serving gives K1: a probe-gated config-4 wave
    # (N=10, B=1024, 100 iterations, warm-started node boxes)
    _, _, spec4, _, f, h, lb, ub = problem(
        10, BATCH, dev, phase_rng("config4_wave"), fix_frac=0.3)
    args = (ca.kernel_qp_for(spec4), f, h, lb, ub)
    r0 = ca.admm_solve_plain(*args, iters=100)
    warm = (r0.x, r0.z, r0.y)
    got = ca.admm_solve_cuda(*args, iters=100, warm=warm)
    ref = ca.admm_solve_plain(*args, iters=100, warm=warm)
    compare("N=10 B=1024 100 it warm (config-4 wave)", got, ref, rec)
    rec["ms"] = cuda_ms(lambda: ca.admm_solve_cuda(*args, iters=100,
                                                   warm=warm))
    rec["kernel_ms"] = kernel_ms(lambda: ca.admm_solve_cuda(
        *args, iters=100, warm=warm))
    rec["plain_ms"] = cuda_ms(lambda: ca.admm_solve_plain(*args, iters=100,
                                                          warm=warm))
    set_bound(rec, args[0], BATCH, products=101, stats=1, warm=True)
    print(f"  N=10 B=1024 100 it warm: wrapper {rec['ms']:.3f} ms, kernel "
          f"alone {rec['kernel_ms']:.3f} ms, plain {rec['plain_ms']:.3f} "
          f"ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})",
          flush=True)

    # bench primary: N=20, B=4096, 100 iterations, cold then warm
    _, _, spec20, _, f, h, lb, ub = problem(20, 4096, dev, rng)
    args = (ca.kernel_qp_for(spec20), f, h, lb, ub)
    got = ca.admm_solve_cuda(*args, iters=100)
    ref = ca.admm_solve_plain(*args, iters=100)
    compare("N=20 B=4096 100 it cold", got, ref, rec)
    warm = (ref.x, ref.z, ref.y)
    got_w = ca.admm_solve_cuda(*args, iters=100, warm=warm)
    ref_w = ca.admm_solve_plain(*args, iters=100, warm=warm)
    compare("N=20 B=4096 100 it warm", got_w, ref_w, rec)
    k = cuda_ms(lambda: ca.admm_solve_cuda(*args, iters=100))
    ka = kernel_ms(lambda: ca.admm_solve_cuda(*args, iters=100))
    p = cuda_ms(lambda: ca.admm_solve_plain(*args, iters=100))
    rec["n20_ms"], rec["n20_kernel_ms"], rec["n20_plain_ms"] = k, ka, p
    rec["n20_bound_ms"] = bound(*admm_work(
        args[0].n_pad, args[0].m_pad, 4096, products=101, stats=1,
        warm=False))[0]
    print(f"  N=20 B=4096 100 it: wrapper {k:.3f} ms, kernel alone "
          f"{ka:.3f} ms, plain {p:.3f} ms, bound "
          f"{rec['n20_bound_ms']:.4f} ms", flush=True)

    # infeasibility certificate: instance 0 has x0 ≤ 1 ∧ x0 ≥ 2
    n = 8
    spec_i = prepare_admm(np.vstack([np.eye(n)[:1], -np.eye(n)[:1]]),
                          np.eye(n), device=dev)
    B = 128
    q = torch.as_tensor(rng.normal(size=(B, n)).astype(np.float32),
                        device=dev)
    hh = torch.tensor([1.0, 2.0], device=dev).repeat(B, 1)
    hh[0] = torch.tensor([1.0, -2.0], device=dev)
    lo = torch.full((B, n), -10.0, device=dev)
    args = (ca.kernel_qp_for(spec_i), q, hh, lo, -lo)
    got = ca.admm_solve_cuda(*args, iters=400)
    ref = ca.admm_solve_plain(*args, iters=400)
    check(bool(got.infeas_cert[0]) and not bool(got.infeas_cert[1:].any()),
          "K1 certificate: must fire on instance 0 only")
    compare("infeasible instance 400 it", got, ref, rec)


def phase_k2(dev, rng, rec):
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    print("K2 (admm_k2) vs plain:", flush=True)
    for N, B, iters, piters, tagk in ((10, 32, 400, 400, "cfg1"),
                                      (10, BATCH, 100, 100, ""),
                                      (20, 4096, 100, 100, "n20")):
        _, qp, spec, spec_p, f, h, lb, ub = problem(
            N, B, dev, rng if tagk else phase_rng("config4_wave"),
            fix_frac=0.3)
        args = (ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p),
                qp.binary_idx, f, h, lb, ub)
        kw = dict(iters=iters, probe_iters=piters)
        tag = f"N={N} B={B} {iters}+{piters} it"
        got = ca.admm_wave_cuda(*args, **kw)
        ref = ca.admm_wave_plain(*args, **kw)
        compare_probe(tag, got, ref, qp, lb, ub, rec)
        warm = (ref[0].x, ref[0].z, ref[0].y)
        got = ca.admm_wave_cuda(*args, warm=warm, **kw)
        ref = ca.admm_wave_plain(*args, warm=warm, **kw)
        compare_probe(tag + " warm", got, ref, qp, lb, ub, rec)
        # timed warm-started, as every wave after the root is; the bound
        # counts (iters+1) + p1 + (p2+1) product pairs and two stats blocks
        k = cuda_ms(lambda: ca.admm_wave_cuda(*args, warm=warm, **kw))
        ka = kernel_ms(lambda: ca.admm_wave_cuda(*args, warm=warm, **kw))
        p = cuda_ms(lambda: ca.admm_wave_plain(*args, warm=warm, **kw))
        b = bound(*admm_work(args[0].n_pad, args[0].m_pad, B,
                             products=iters + piters + 2, stats=2,
                             warm=True, stiff=True, outputs=2))
        pre = tagk + "_" if tagk else ""
        rec[pre + "ms"], rec[pre + "plain_ms"] = k, p
        rec[pre + "kernel_ms"] = ka
        rec[pre + "bound_ms"] = b[0]
        if not tagk:     # config 4's wave: the shape of the batched path
            rec["bound_by"], rec["library_ms"] = b[1], None
        chain = chain_ms(args[0].n_pad, args[0].m_pad, iters + piters + 2)
        rec[pre + "chain_ms"] = chain
        print(f"  {tag} warm: wrapper {k:.3f} ms, kernel alone {ka:.3f} "
              f"ms, plain {p:.3f} ms, bound "
              f"{b[0]:.4f} ms ({b[1]}), one problem's dependent chain "
              f"{chain:.4f} ms", flush=True)


def phase_far(dev, rng, recs):
    """K1 and K2 far from convergence, at odd batch sizes, with and
    without the stiff probe; then the shared-memory shape limit."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    print(f"K1/K2 far from convergence (N=10, {FAR_ITERS} it, probe "
          f"{FAR_ITERS // 2}+{FAR_ITERS - FAR_ITERS // 2}):", flush=True)
    kw = dict(iters=FAR_ITERS, probe_iters=FAR_ITERS)
    for N, B in [(10, b) for b in FAR_BATCHES] + [(21, 8)]:
        _, qp, spec, spec_p, f, h, lb, ub = problem(N, B, dev, rng,
                                                    fix_frac=0.3)
        kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
        args = (kq, f, h, lb, ub)
        compare(f"K1 N={N} B={B}",
                ca.admm_solve_cuda(*args, iters=FAR_ITERS),
                ca.admm_solve_plain(*args, iters=FAR_ITERS),
                recs["admm_k1"], "far")
        for stiff in (kq2, None):
            args = (kq, stiff, qp.binary_idx, f, h, lb, ub)
            got = ca.admm_wave_cuda(*args, **kw)
            ref = ca.admm_wave_plain(*args, **kw)
            tag = f"K2 N={N} B={B}" + (" stiff" if stiff else "")
            compare_probe(tag, got, ref, qp, lb, ub, recs["admm_k2"], "far")

    # every problem-tile instantiation at batches that are no multiple of
    # the tile: the last block's missing problems are masked in the kernel
    for N, B in ((10, 37), (21, 11)):
        _, qp, spec, spec_p, f, h, lb, ub = problem(N, B, dev, rng,
                                                    fix_frac=0.3)
        kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
        ref1 = ca.admm_solve_plain(kq, f, h, lb, ub, iters=FAR_ITERS)
        args = (kq, kq2, qp.binary_idx, f, h, lb, ub)
        ref2 = ca.admm_wave_plain(*args, **kw)
        for pb in ca.TILES:
            tag = f"N={N} B={B} tile {pb}"
            compare("K1 " + tag,
                    ca.admm_solve_cuda(kq, f, h, lb, ub, iters=FAR_ITERS,
                                       pb=pb), ref1, recs["admm_k1"], "far")
            compare_probe("K2 " + tag + " stiff",
                          ca.admm_wave_cuda(*args, pb=pb, **kw), ref2, qp,
                          lb, ub, recs["admm_k2"], "far")

    # the plan at the main shapes, and the library's own shared-memory
    # reckoning beside the wrapper's
    lib = load_library()
    for N, B in ((10, BATCH), (10, 32), (20, 4096), (21, 8)):
        kq = ca.kernel_qp_for(problem(N, 1, dev, rng)[2])
        pl = ca.plan(B, kq.n_pad, kq.m_pad)
        need = lib.phc_admm_smem_bytes(kq.n_pad, kq.m_pad, pl.pb,
                                       int(pl.streamed), pl.cluster)
        check(need == pl.smem, f"plan: N={N} B={B} reckons {pl.smem} bytes "
              f"of shared memory, the library {need}")
        print(f"  plan N={N} B={B}: tile of {pl.pb} problems, "
              f"{-(-B // pl.pb)} blocks of {pl.threads} threads, {pl.smem} "
              f"bytes of shared memory per block (limit {ca.SMEM_MAX}), "
              f"the same for K1 and K2", flush=True)
    fits = [N for N in range(20, 40) if ca.smem_bytes(
        -(-3 * N // 8) * 8, -(-10 * N // 8) * 8, 1) <= ca.SMEM_MAX]
    print(f"  largest horizon of this model whose constants a block can "
          f"stage: N={max(fits)}", flush=True)
    # above it the plan deals the constants over a cluster (phase_streamed
    # holds that variant); asked to stage them, the wrapper refuses, it does
    # not fall back
    _, qp, spec, spec_p, f, h, lb, ub = problem(60, 2, dev, rng)
    kq = ca.kernel_qp_for(spec)
    args = (kq, ca.kernel_qp_for(spec_p), qp.binary_idx, f, h, lb, ub)
    try:
        ca.admm_wave_cuda(*args, streamed=False, **kw)
    except ValueError as e:
        print(f"  N=60 with staged constants refused by the wrapper: {e}",
              flush=True)
    else:
        raise AssertionError("N=60: the wrapper must refuse to stage the "
                             "constants")
    pl = ca.plan(2, kq.n_pad, kq.m_pad)
    check(pl.cluster > 1, f"N=60: the plan must hold the constants over a "
          f"cluster: {pl}")
    print(f"  plan N=60 B=2: {pl}", flush=True)


def mixed_iterates(tag, kq16, packed, k0, tiles):
    """The tensor-core kernel's own outputs after ONE split-precision
    iteration from the plain version's iterates after ``k0`` of them, at
    each tile width of ``tiles`` (None: the plan's)."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    cold = ca._init_iterates(*packed[1:], None)
    it = tuple(t.contiguous() for t in
               ca._mixed_plain(kq16, *packed, cold, k0))
    ref = ca._mixed_plain(kq16, *packed, it, 1)
    B = packed[0].shape[0]
    for tile in tiles:
        pl = ca.plan_mixed(B, kq16.n_pad, kq16.m_pad, tile=tile)
        got = ca._launch_k1_mixed(kq16, *packed, it, 1, tile=tile)
        held(f"{tag} one split-precision it after {k0}, tile {pl.tile}",
             "mixed_iterates",
             dict(zip(("zG", "yG", "zB", "yB"), zip(got, ref))))


def mixed_tiles_and_limit(dev, rng, rec):
    """The split-precision kernel's tile widths at batches that leave a
    ragged last tile, and its shape limit."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    # both tile widths at batches that leave a ragged last tile, and N=21,
    # which fits a tile of 16 only: one iteration at every width that fits,
    # the whole solve at the plan's
    lib = load_library("admm_mixed")
    for N, B in ((12, 1), (12, 33), (12, 4095), (20, 4095), (21, 37)):
        _, qp, spec, _, f, h, lb, ub = problem(N, B, dev, rng)
        kq = ca.kernel_qp_for(spec)
        kq16 = ca.pad_kernel_qp(kq)
        nr, mGp = kq16.n_pad, kq16.m_pad
        tiles = []
        for t in ca.MIXED_TILES:
            try:
                tiles.append(ca.plan_mixed(B, nr, mGp, tile=t).tile)
            except ValueError:
                pass
        packed = ca._pack(kq16, f, h, lb, ub, None)[:5]
        mixed_iterates(f"N={N} B={B}", kq16, packed, MIXED_WARM[0], tiles)
        pl = ca.plan_mixed(B, nr, mGp)
        need = lib.phc_admm_mixed_smem_bytes(nr, mGp, pl.tile)
        check(need == pl.smem, f"plan_mixed: N={N} B={B} reckons {pl.smem} "
              f"bytes of shared memory, the library {need}")
        iters = 120 if N == 12 else 100
        args = (kq, f, h, lb, ub)
        compare(f"N={N} B={B} {iters} it low_frac=1.0 (tile {pl.tile})",
                ca.admm_solve_cuda(*args, iters=iters, low_frac=1.0),
                ca.admm_solve_plain(*args, iters=iters, low_frac=1.0), rec,
                "mixed")
        print(f"  plan_mixed N={N} B={B}: tile of {pl.tile} problems, "
              f"{-(-B // pl.tile)} blocks of {pl.threads} threads, "
              f"{pl.smem} bytes of shared memory per block (limit "
              f"{ca.SMEM_MAX}); widths that fit {tiles}", flush=True)
    # the shape limit: the tensor-core kernel refuses N=22, where the
    # split-precision phase runs in K1's split mode (phase_split)
    _, qp, spec, _, f, h, lb, ub = problem(22, 2, dev, rng)
    kq16 = ca.pad_kernel_qp(ca.kernel_qp_for(spec))
    try:
        ca.plan_mixed(2, kq16.n_pad, kq16.m_pad)
    except ValueError as e:
        print(f"  N=22 refused by the tensor-core kernel's plan: {e}",
              flush=True)
    else:
        raise AssertionError("N=22: the tensor-core plan must refuse the "
                             "shape")
    check(ca.split_route(kq16.n_pad, kq16.m_pad) == "k1_split",
          "N=22: the split-precision phase must route to K1's split mode")


def phase_k1_mixed(dev, rng, rec):
    """K1 with its split-precision phase against the plain version (both
    tile widths, ragged batches, the shape limit), then the relaxation
    sweep's gate against full-precision K1."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    print("K1 split-precision phase (admm_k1_mixed) vs plain:", flush=True)
    for N, B, iters in ((12, 128, 120), (20, 4096, 100)):
        _, qp, spec, _, f, h, lb, ub = problem(N, B, dev, rng)
        kq = ca.kernel_qp_for(spec)
        args = (kq, f, h, lb, ub)
        # the tensor-core kernel's own outputs, before the drift has grown
        kq16 = ca.pad_kernel_qp(kq)
        packed = ca._pack(kq16, f, h, lb, ub, None)[:5]
        for k0 in MIXED_WARM:
            mixed_iterates(f"N={N} B={B}", kq16, packed, k0, (None,))
        full = ca.admm_solve_cuda(*args, iters=iters)
        for lf in (0.8, 1.0):
            got = ca.admm_solve_cuda(*args, iters=iters, low_frac=lf)
            ref = ca.admm_solve_plain(*args, iters=iters, low_frac=lf)
            compare(f"N={N} B={B} {iters} it low_frac={lf}", got, ref, rec,
                    "mixed")
        gate = float(((got.obj - full.obj).abs()
                      / torch.clamp_min(full.obj.abs(), 1.0)).max())
        print(f"  N={N} B={B}: low_frac=1.0 vs full-precision K1, max "
              f"relative objective delta {gate:.2e} (gate {MIXED_GATE:.0e})",
              flush=True)
        check(gate <= MIXED_GATE, f"mixed gate: {gate:.3e} > {MIXED_GATE}")
        rec[f"n{N}_gate"] = gate
    # the bench primary is the shape the relaxation sweep gives the kernel
    times = {}
    for name, fn in (
            ("ms", lambda: ca.admm_solve_cuda(*args, iters=100,
                                              low_frac=1.0)),
            ("lf08_ms", lambda: ca.admm_solve_cuda(*args, iters=100,
                                                   low_frac=0.8)),
            ("full_ms", lambda: ca.admm_solve_cuda(*args, iters=100)),
            ("plain_ms", lambda: ca.admm_solve_plain(*args, iters=100,
                                                     low_frac=1.0)),
            ("lf08_plain_ms", lambda: ca.admm_solve_plain(
                *args, iters=100, low_frac=0.8))):
        times[name] = cuda_ms(fn)
    rec.update(times)
    for name, lf in (("kernel_ms", 1.0), ("lf08_kernel_ms", 0.8)):
        rec[name] = kernel_ms(lambda: ca.admm_solve_cuda(
            *args, iters=100, low_frac=lf))
    rec["lf08_bound_ms"] = bound(*admm_work(
        kq.n_pad, kq.m_pad, 4096, products=21, stats=1, warm=False,
        lo_products=80))[0]
    # the function's own shape (nr=64, mGp=200), not the 16-grain padding
    set_bound(rec, kq, 4096, products=1, stats=1, warm=False,
              lo_products=100)
    print(f"  N=20 B=4096 100 it: low_frac=1.0 wrapper {rec['ms']:.3f} ms, "
          f"kernels alone {rec['kernel_ms']:.3f} ms, plain "
          f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}); low_frac=0.8 wrapper "
          f"{rec['lf08_ms']:.3f} ms, kernels alone "
          f"{rec['lf08_kernel_ms']:.3f} ms, plain "
          f"{rec['lf08_plain_ms']:.3f} ms, bound "
          f"{rec['lf08_bound_ms']:.4f} ms; full-precision K1 "
          f"{rec['full_ms']:.3f} ms", flush=True)
    mixed_tiles_and_limit(dev, rng, rec)
    return args


def phase_dispatch(dev, rng):
    """On a CUDA tensor no path reaches a plain version: with the plain
    versions made to raise, the entry points still answer, and each counts
    a launch of its kernel."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")

    _, qp, spec, spec_p, f, h, lb, ub = problem(10, 48, dev, rng)
    _, qp27, spec27, spec27_p, f27, h27, lb27, ub27 = problem(27, 8, dev, rng)
    saved = {k: getattr(ca, k) for k in
             ("admm_solve_plain", "admm_wave_plain", "_solve_plain",
              "_mixed_plain", "_relax", "_phase")}
    for k in saved:
        setattr(ca, k, refuse)
    none = dict.fromkeys(ca.LAUNCHES, 0)
    try:
        ca.reset_launch_counts()
        ca.admm_solve_auto(spec, f, h, lb, ub, iters=10)
        check(ca.LAUNCHES["admm_k1"] == 1, "admm_solve_auto: no K1 launch")
        ca.admm_wave_auto(spec, spec_p, qp.binary_idx, f, h, lb, ub,
                          iters=10, probe_iters=10)
        check(ca.LAUNCHES["admm_k2"] == 1, "admm_wave_auto: no K2 launch")
        ca.admm_solve_cuda(ca.kernel_qp_for(spec), f, h, lb, ub, iters=10,
                           low_frac=0.5)
        check(ca.LAUNCHES == {**none, "admm_k1": 2, "admm_k2": 1,
                              "admm_k1_mixed": 1},
              f"admm_solve_cuda(low_frac): launches {ca.LAUNCHES}")
        # above the shared-memory cap: the resident variants and split mode
        ca.reset_launch_counts()
        ca.admm_solve_auto(spec27, f27, h27, lb27, ub27, iters=10)
        ca.admm_wave_auto(spec27, spec27_p, qp27.binary_idx, f27, h27, lb27,
                          ub27, iters=10, probe_iters=10)
        ca.admm_solve_cuda(ca.kernel_qp_for(spec27), f27, h27, lb27, ub27,
                           iters=10, low_frac=0.5)
        check(ca.LAUNCHES == {**none, "admm_k1_resident": 2,
                              "admm_k2_resident": 1, "admm_k1_split": 1},
              f"N=27: launches {ca.LAUNCHES}")
    finally:
        for k, v in saved.items():
            setattr(ca, k, v)
    print(f"no plain version behind a CUDA tensor: launches {ca.LAUNCHES}, "
          f"batch sizes {ca.LAUNCH_BATCHES}", flush=True)


# (n, m) of the shapes whose constants a block cannot stage: the double
# integrator at N=27 and the reference bench's configs 3, 4b, 4c and 2/2b.
# Configs 2, 3, 4b and 4c are their real condensed problems (REAL_CONFIGS;
# config 4c the dense joint frame of its scenario tree, with node boxes
# that fix whole information-set groups, as its pool does); N=27 is a
# random problem of its size. The certificate bits may differ near a
# threshold on the frames of CERT_FRAMES only (CERT_BAND).
BIG_SHAPES = {"N27": (81, 270), "config3": (108, 239), "config4b": (120, 216),
              "config4c": (120, 444), "config2": (220, 680)}
REAL_CONFIGS = ("config2", "config3", "config4b", "config4c")
CERT_FRAMES = ("config2", "config3", "config4b")
BIG_BATCHES = (1, 37, 300)
SPLIT_HORIZONS = (22, 24, 27)     # K1's split mode, above the tensor cores'


def random_problem(n, m, B, dev, rng, fix_frac=0.3):
    """A random box-QP of n variables and m rows G x ≤ h: H = MMᵀ/n + I,
    G with unit-variance rows, h feasible for a point of the box with a
    margin, |x| ≤ 1, the first n/5 variables binary (node boxes fixing
    ``fix_frac`` of them). Returns prepared specs (ρ and stiff ρ), the
    binary indices and a batch of B problems (q, h, lb, ub)."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm

    Mh = rng.normal(size=(n, n))
    H = Mh @ Mh.T / n + np.eye(n)
    G = rng.normal(size=(m, n)) / np.sqrt(n)
    nb = max(1, n // 5)
    spec = prepare_admm(G, H, device=dev)
    spec_p = prepare_admm(G, H, rho=10.0, device=dev)
    xf = rng.uniform(-0.5, 0.5, size=(B, n))
    xf[:, :nb] = rng.uniform(0.0, 1.0, size=(B, nb))
    h = xf @ G.T + rng.uniform(0.1, 1.0, size=(B, m))
    q = rng.normal(size=(B, n))
    lb, ub = -np.ones((B, n)), np.ones((B, n))
    fm = rng.uniform(size=(B, nb)) < fix_frac
    fv = (rng.uniform(size=(B, nb)) < 0.5).astype(float)
    lb[:, :nb] = np.where(fm, fv, 0.0)
    ub[:, :nb] = np.where(fm, fv, 1.0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return spec, spec_p, tuple(range(nb)), t(q), t(h), t(lb), t(ub)


# The reference bench's configurations 2/2b, 3 and 4b as the port builds
# them (bench.py:453-512, 515-554, 596-653, 861-928)
DEWH_N = 24             # configs 3 and 4b
DEWH_ROWS = 7           # DEWH stage rows; rows 0 and 1 are the comfort band
# A plan is feasible in fp64 where every row of G V ≤ h and of the box holds
# within the B&B's own acceptance tolerance (BnbSpec.feas_tol, on the
# per-row relative residual the solver reports), and every binary is within
# it of 0 or 1.
FEAS_TOL = 1e-3


def bench_frame(name, N=None):
    """(model, weights, CondensedMpc) of the reference bench's ``name``:
    "config2", the PWA spring in its hull encoding with the on/off actuator
    (N=20); "config5", the same spring big-M encoded at N=14
    (scripts/config5_pool4096.py); "config3", DEWH with min-up 2, blocks
    of two steps and the soft comfort band (N=24); "config4b", DEWH with
    the soft comfort band (N=24); "config4c", the dense joint frame of
    config 4c's scenario tree (S=4, N=10). ``N`` shortens the horizon."""
    from pyhybridcontrol_tpu_torch.models import (
        di_default_weights, dewh_model, dewh_weights, min_up_down_rows,
        pwa_spring_mld, pwa_weights)
    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
    from pyhybridcontrol_tpu_torch.ops.scenario_tree import (
        build_scenario_tree_qp)

    if name == "config4c":
        model, w = omega_model(), di_default_weights()
        return model, w, build_scenario_tree_qp(
            CondensedMpc(model, CFG4C_N, w), config4c_tree()[0])
    if name == "config2":
        model, w = pwa_spring_mld(on_off=True, formulation="hull"), \
            pwa_weights()
        return model, w, CondensedMpc(model, N or 20, w)
    if name == "config5":
        model, w = pwa_spring_mld(on_off=True), pwa_weights()
        return model, w, CondensedMpc(model, N or MD_CFG5_N, w)
    N = N or DEWH_N
    model, w = dewh_model(), dewh_weights()
    c = CondensedMpc(model, N, w)
    if name == "config3":
        c = (c.with_extra_constraints(*min_up_down_rows(N, model.info.nv,
                                                        min_up=2))
             .with_move_blocking([k // 2 for k in range(N)]))
    return model, w, c.with_soft_constraints(
        dewh_soft_rows(N), lin_pen=5.0, quad_pen=1.0)


# Config 4c of the reference bench (bench.py:654-705): scenario-tree MIQPs of
# the double integrator with an additive velocity disturbance, S=4
# scenarios of N=10 steps branching at steps 1 and 5 (tree-consistent paths
# of default_rng(13), sd 0.2), each one instance of the dense joint frame
# (n=120, m=444, 40 binaries in 29 information-set groups), pooled with
# rep-map branching
CFG4C_S, CFG4C_N, CFG4C_STEPS = 4, 10, (1, 5)


def omega_model():
    """The switched double integrator with an additive disturbance on its
    velocity (config 4c's model and the reference tree tests')."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.mld.info import MldInfo
    from pyhybridcontrol_tpu_torch.mld.model import MldModel
    from pyhybridcontrol_tpu_torch.models import switched_double_integrator

    base = switched_double_integrator()
    m = base.numpy_mats()
    return MldModel.from_matrices(
        MldInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=1, ny=2,
                ncons=base.info.ncons),
        A=m.A, B1=m.B1, B3=m.B3, B4=np.array([[0.0], [1.0]]), C=m.C,
        E=m.E, F1=m.F1, F2=m.F2, F3=m.F3, f5=m.f5)


def config4c_tree():
    """(tree, rng) of config 4c: the bench's rng after it drew the paths,
    from which the bench then draws its states."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.ops.scenario_tree import (
        ScenarioTree, tree_consistent_paths)

    rng = np.random.default_rng(13)
    paths = tree_consistent_paths(rng, CFG4C_S, CFG4C_N, CFG4C_STEPS, sd=0.2)
    return ScenarioTree.from_branching(paths, branch_steps=CFG4C_STEPS), rng


def config4c_groups():
    """Information-set group of each binary of config 4c's joint frame."""
    from pyhybridcontrol_tpu_torch.ops.scenario_tree import tree_branch_map

    return tree_branch_map(bench_frame("config4c")[2], config4c_tree()[0])


def dewh_soft_rows(N):
    return [k * DEWH_ROWS + r for k in range(N) for r in (0, 1)]


def bench_data(name, N, B, rng, T=0):
    """Seeded data of B instances of ``name`` for a horizon N and T steps:
    states (B, nx), hot-water draws (B, N+T, 1) (25% of steps draw half a
    unit, as the bench's) and flat 0.15 $/kWh prices (N+T, nv); no draws
    nor prices for config 2."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.models import (
        DewhParams, dewh_energy_price_seq)

    if name in ("config2", "config5"):
        return (rng.uniform([-2.0, -1.0], [2.0, 1.0], (B, 2))
                .astype(np.float32), None, None)
    if name == "config4c":      # states as the bench's; the tree's paths
        x0s = rng.normal(size=(B, 2)).astype(np.float32)
        W = config4c_tree()[0].omega_paths.reshape(1, -1, 1)
        return x0s, np.repeat(W, B, axis=0).astype(np.float32), None
    x0s = np.stack([rng.uniform(50.0, 62.0, B),
                    rng.integers(0, 2, B)], axis=1).astype(np.float32)
    draws = (0.5 * (rng.uniform(0, 1, (B, N + T, 1)) < 0.25)
             ).astype(np.float32)
    prices = dewh_energy_price_seq(np.full(N + T, 0.15), DewhParams(),
                                   nv=2).astype(np.float32)
    return x0s, draws, prices


def flip_share(name):
    return FLIP_SHARE_HULL if name == "config2" else FLIP_SHARE


def on_card(dev, *arrays):
    import torch

    return tuple(None if a is None else torch.as_tensor(a, device=dev)
                 for a in arrays)


def real_problem(name, B, dev, rng, fix_frac=0.3):
    """The condensed problem of ``name`` (``bench_frame``) at B seeded
    states, as ``random_problem`` returns one: prepared specs (ρ and stiff
    ρ=10), binary indices, (f, h) and B&B-node boxes fixing ``fix_frac`` of
    the binaries."""
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc

    _, _, c = bench_frame(name)
    qp = c.device_qp(dev)
    x0s, W, P = on_card(dev, *bench_data(name, c.N, B, rng))
    f, h = qp.assemble(x0s, W, price_seq=P)
    lb, ub = node_boxes(qp, B, rng, fix_frac,
                        config4c_groups() if name == "config4c" else None)
    return (prepare_admm_mpc(c, device=dev),
            prepare_admm_mpc(c, rho=10.0, device=dev), qp.binary_idx, f, h,
            lb, ub)


def plan_reading(c, V, x0, W=None, P=None):
    """fp64 reading of decision V of frame ``c`` at state x0: (the largest
    relative violation of G V ≤ h and of the box — per row over
    max(1, |row value|), as the solver's r_prim_rel — the largest distance
    of a binary from 0/1, the objective ½VᵀHV + fᵀV)."""
    import numpy as np

    f, h = c.assemble_np(x0, W, price_seq=P)
    V = np.asarray(V, np.float64)
    GV = c.G @ V
    rows = np.maximum(GV - h, 0.0) / np.maximum(1.0, np.abs(GV))
    box = (np.maximum(np.maximum(c.lb - V, V - c.ub), 0.0)
           / np.maximum(1.0, np.abs(V)))
    vb = V[c.binary_idx]
    return (float(max(rows.max(), box.max())),
            float(np.abs(vb - np.round(vb)).max()),
            float(0.5 * V @ c.H @ V + f @ V))


def plans_feasible(tag, c, plans):
    """Every (V, x0, W, P) of ``plans`` feasible in fp64 (FEAS_TOL);
    prints the worst readings. Returns the recomputed objectives."""
    worst, wbits, objs = 0.0, 0.0, []
    for V, x0, W, P in plans:
        feas, bits, obj = plan_reading(c, V, x0, W, P)
        worst, wbits = max(worst, feas), max(wbits, bits)
        objs.append(obj)
    print(f"  {tag}: {len(plans)} plans in fp64, worst relative row/box "
          f"violation {worst:.2e}, worst binary off 0/1 {wbits:.2e} "
          f"(limit {FEAS_TOL:.0e})", flush=True)
    check(worst <= FEAS_TOL, f"{tag}: a plan violates G V ≤ h or its box "
          f"by {worst:.3e}")
    check(wbits <= FEAS_TOL, f"{tag}: a binary is {wbits:.3e} off 0/1")
    return objs


def timed(rec, pre, wrapper, plain, work):
    """Wrapper ms, kernels-alone ms, plain ms and the bound of one shape
    into ``rec`` under keys prefixed ``pre``."""
    rec[pre + "ms"] = cuda_ms(wrapper)
    rec[pre + "kernel_ms"] = kernel_ms(wrapper)
    rec[pre + "plain_ms"] = cuda_ms(plain)
    rec[pre + "bound_ms"], by = bound(*work)
    print(f"  {pre.rstrip('_') or 'main shape'}: wrapper "
          f"{rec[pre + 'ms']:.3f} ms, kernel alone "
          f"{rec[pre + 'kernel_ms']:.3f} ms, plain "
          f"{rec[pre + 'plain_ms']:.3f} ms, bound "
          f"{rec[pre + 'bound_ms']:.3g} ms ({by})", flush=True)
    return by


# the resident variant's stats against the L2-streamed one's at the same
# tile: the same per-row values, summed per CTA and then across the CTAs in
# fp64 (another order than one block's), so within this relative limit
STATS_REL = 1e-12


def held_bitwise(tag, got, ref):
    """The resident variant (``got``) against the L2-streamed one forced at
    the same tile (``ref``): x, z and y bitwise equal (every output is the
    same task of the same routine in the same order), the stats within
    STATS_REL relative, certificate bits identical. Returns the largest
    relative stats difference."""
    import torch

    for k in ("x", "z", "y"):
        check(torch.equal(getattr(got, k), getattr(ref, k)),
              f"{tag}: {k} differs from the L2-streamed variant at the same "
              f"tile")
    worst = 0.0
    for k in ("obj", "r_prim", "r_prim_rel", "r_dual"):
        g, r = getattr(got, k).double(), getattr(ref, k).double()
        rel = (g - r).abs() / torch.clamp_min(r.abs(), 1e-300)
        worst = max(worst, float(rel.max()))
    check(worst <= STATS_REL, f"{tag}: stats {worst:.3e} (relative) off the "
          f"L2-streamed variant's")
    check(torch.equal(got.infeas_cert, ref.infeas_cert),
          f"{tag}: certificate bits differ from the L2-streamed variant's")
    BITWISE[0] += 1
    BITWISE[1] = max(BITWISE[1], worst)
    return worst


BITWISE = [0, 0.0]   # resident-vs-streamed holds passed, largest stats Δ


def l2(kq, pl):
    """Arguments that force the L2-streamed variant at the tile that sums
    as the resident plan ``pl`` does: its own tile where a block holds
    that tile's iterates, else the largest smaller one with the same lane
    groups (tiles of 8 and 4 run the same products, row for row)."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    t = next(t for t in ca.TILES if t <= pl.pb
             and ca.B_KS[t] == ca.B_KS[pl.pb]
             and ca.smem_bytes(kq.n_pad, kq.m_pad, t, True) <= ca.SMEM_MAX)
    return dict(pb=t, streamed=True)


def timed_variants(r_res, r_str, pre, resident, streamed, plain, work):
    """``timed`` of the resident wrapper into ``r_res`` and the L2-streamed
    one forced at the same tile (alone and wrapper) into ``r_str``, under
    keys prefixed ``pre``."""
    by = timed(r_res, pre, resident, plain, work)
    r_str[pre + "kernel_ms"] = kernel_ms(streamed)
    r_str[pre + "ms"] = cuda_ms(streamed)
    r_str[pre + "bound_ms"] = r_res[pre + "bound_ms"]
    print(f"  {pre.rstrip('_') or 'main shape'}: L2-streamed at the same "
          f"tile, kernel alone {r_str[pre + 'kernel_ms']:.3f} ms, wrapper "
          f"{r_str[pre + 'ms']:.3f} ms", flush=True)
    return by


def plan_line(name, kq, B, wave=True, split=False):
    """The plan of ``name`` at B, which must be resident, with the clusters
    the card holds at once; printed."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    pl = ca.plan(B, kq.n_pad, kq.m_pad)
    check(pl.cluster > 1 and not pl.streamed,
          f"{name} B={B}: the plan must hold the constants over a cluster, "
          f"got {pl}")
    need = load_library().phc_admm_smem_bytes(kq.n_pad, kq.m_pad, pl.pb, 0,
                                              pl.cluster)
    check(need == pl.smem, f"{name}: the plan reckons {pl.smem} bytes of "
          f"shared memory, the library {need}")
    cap = ca.cluster_capacity(kq, wave, split, pl)
    print(f"  plan {name} (padded {kq.n_pad}/{kq.m_pad}) B={B}: tile of "
          f"{pl.pb} problems, {-(-B // pl.pb)} clusters of {pl.cluster} CTAs "
          f"of {pl.threads} threads, {pl.smem} bytes of shared memory a CTA, "
          f"{cap} clusters at once on the card", flush=True)
    return pl, cap


def cluster_barrier_ns(rec, threads=256, iters=2000):
    """One cluster barrier's cost (ns) at C = 1, 2, 4, 8, 16: a kernel that
    passes only barriers, timed with ``iters`` and 2·``iters`` of them (CUDA
    events; the difference over ``iters``), with one cluster and with 132/C
    clusters; with the release / acquire semantics of ``cluster.sync()``
    (the fence that makes writes into other CTAs seen) and relaxed."""
    import torch

    from pyhybridcontrol_tpu_torch.ops._build import load_library

    lib = load_library()
    stream = torch.cuda.current_stream().cuda_stream

    def run(C, clusters, n, relaxed):
        rc = lib.phc_cluster_sync_bench(C, clusters, threads, n, relaxed,
                                        stream)
        check(rc == 0, f"cluster barrier bench C={C}: "
              f"{lib.phc_error_string(rc).decode()}")

    out = {}
    for C in (1, 2, 4, 8, 16):
        for relaxed in (0, 1):
            for label, clusters in (("one", 1), ("card", 132 // C)):
                run(C, clusters, 10, relaxed)
                ts = []
                for n in (iters, 2 * iters):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    run(C, clusters, n, relaxed)
                    e1.record()
                    torch.cuda.synchronize()
                    ts.append(e0.elapsed_time(e1))
                key = label + ("_relaxed" if relaxed else "")
                out.setdefault(C, {})[key] = 1e6 * (ts[1] - ts[0]) / iters
        o = out[C]
        print(f"  cluster barrier, C={C} ({threads} threads a CTA), release/"
              f"acquire: one cluster {o['one']:.1f} ns, {132 // C} clusters "
              f"{o['card']:.1f} ns; relaxed: {o['one_relaxed']:.1f} / "
              f"{o['card_relaxed']:.1f} ns", flush=True)
    rec["cluster_barrier_ns"] = out


def phase_streamed(dev, rng, recs):
    """K1 and K2 at the five shapes a block cannot stage (the real problems
    of configs 2, 3, 4b and 4c, a random one of N=27's size; B = 1, 37,
    300): the plan's resident variant (a cluster holds the constants)
    against the plain versions ("main" limits) and, bitwise on x, z and y,
    against the L2-streamed variant forced at the same tile; both
    variants' times at B=300; the L2-streamed and the resident variants
    forced at N=26 against the staged one (bitwise at a tile of 1); the
    times at the N=27 paths' shapes (K1 at B=4096, 100 iterations; K2 at
    the closed loop's wave, B=32, 200 + 100/100 iterations). First, one
    cluster barrier's cost at C = 1 to 16."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    r1, r2 = recs["admm_k1_resident"], recs["admm_k2_resident"]
    s1, s2 = recs["admm_k1_streamed"], recs["admm_k2_streamed"]
    print("cluster barrier microbenchmark:", flush=True)
    cluster_barrier_ns(r2)
    print("K1/K2 with the constants over a cluster (admm_k1_resident, "
          "admm_k2_resident) vs plain, and vs L2-streamed at the same tile:",
          flush=True)
    for name, (n, m) in BIG_SHAPES.items():
        for B in BIG_BATCHES:
            if name in REAL_CONFIGS:
                spec, spec_p, bidx, q, h, lb, ub = real_problem(
                    name, B, dev, rng)
                check((spec.P.shape[0], spec.m_ineq) == (n, m),
                      f"{name}: the frame is {spec.P.shape[0]}/"
                      f"{spec.m_ineq}, not {n}/{m}")
            else:
                spec, spec_p, bidx, q, h, lb, ub = random_problem(
                    n, m, B, dev, rng)
            kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
            pl, _ = plan_line(name, kq, B)
            forced = l2(kq, pl)
            tag = f"{name} (n={n}, m={m}) B={B} tile {pl.pb} C={pl.cluster}"
            args = (kq, q, h, lb, ub)
            # the real frames' certificate bits may differ near a threshold
            plain = args if name in CERT_FRAMES else None
            ref = ca.admm_solve_plain(*args, iters=100)
            got = ca.admm_solve_cuda(*args, iters=100)
            compare("K1 " + tag, got, ref, r1,
                    near=plain and (lambda: cert_factor(plain, ref)))
            held_bitwise("K1 " + tag, got, ca.admm_solve_cuda(
                *args, iters=100, **forced))
            wargs = (kq, kq2, bidx, q, h, lb, ub)
            kw = dict(iters=100, probe_iters=100)
            got = ca.admm_wave_cuda(*wargs, **kw)
            compare_probe("K2 " + tag, got, ca.admm_wave_plain(*wargs, **kw),
                          types.SimpleNamespace(binary_idx=bidx), lb, ub,
                          r2, flip_share=flip_share(name), plain=plain,
                          probe_regime=plain and "real_probe")
            st = ca.admm_wave_cuda(*wargs, **forced, **kw)
            held_bitwise("K2 relaxation " + tag, got[0], st[0])
            held_bitwise("K2 probe " + tag, got[1], st[1])
        # the time at a few hundred problems, where the card is filled
        timed_variants(
            r1, s1, f"{name}_", lambda: ca.admm_solve_cuda(*args, iters=100),
            lambda: ca.admm_solve_cuda(*args, iters=100, **forced),
            lambda: ca.admm_solve_plain(*args, iters=100),
            admm_work(kq.n_pad, kq.m_pad, 300, products=101, stats=1,
                      warm=False))
    print(f"  resident vs L2-streamed: {BITWISE[0]} holds bitwise on x, z, "
          f"y; largest relative stats difference {BITWISE[1]:.2e} (limit "
          f"{STATS_REL:.0e})", flush=True)

    # N=26: the largest staged shape, forced through the other variants
    _, qp, spec, spec_p, f, h, lb, ub = problem(26, 4096, dev, rng,
                                                 fix_frac=0.3)
    kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
    args = (kq, f, h, lb, ub)
    staged = ca.admm_solve_cuda(*args, iters=100)
    # at the same tile the variants run the same arithmetic in the same
    # order: bitwise the same results
    check(torch_equal(ca.admm_solve_cuda(*args, iters=100, pb=1,
                                         streamed=True), staged),
          "N=26: streamed and staged K1 with a tile of 1 differ")
    held_bitwise("K1 N=26 B=4096 resident (C=2, tile 1) vs staged (tile 1)",
                 ca.admm_solve_cuda(*args, iters=100, pb=1, cluster=2),
                 staged)
    # the streamed plan's tile of 8 sums in another order: N=26's noise
    streamed = ca.admm_solve_cuda(*args, iters=100, streamed=True)
    compare("K1 N=26 B=4096 streamed (tile 8) vs staged (tile 1)",
            streamed, staged, s1, "large")
    print(f"  N=26: plans staged {ca.plan(4096, kq.n_pad, kq.m_pad)}, "
          f"streamed {ca.plan(4096, kq.n_pad, kq.m_pad, streamed=True)}; "
          f"with a tile of 1 staged, streamed and resident bitwise equal",
          flush=True)
    for st in (False, True):
        s1[f"n26_{'streamed' if st else 'staged'}_kernel_ms"] = kernel_ms(
            lambda: ca.admm_solve_cuda(*args, iters=100, streamed=st))
    r1["n26_resident_kernel_ms"] = kernel_ms(
        lambda: ca.admm_solve_cuda(*args, iters=100, pb=8, cluster=2))
    print(f"  N=26 B=4096 100 it, kernel alone: staged (tile 1) "
          f"{s1['n26_staged_kernel_ms']:.3f} ms, streamed (tile 8) "
          f"{s1['n26_streamed_kernel_ms']:.3f} ms, resident (C=2, tile 8) "
          f"{r1['n26_resident_kernel_ms']:.3f} ms", flush=True)
    wargs = (kq, kq2, qp.binary_idx, f[:300], h[:300], lb[:300], ub[:300])
    kw = dict(iters=100, probe_iters=100)
    got, ref = (ca.admm_wave_cuda(*wargs, pb=1, streamed=st, **kw)
                for st in (True, False))
    check(torch_equal(got[0], ref[0]) and torch_equal(got[1], ref[1]),
          "N=26: streamed and staged K2 with a tile of 1 differ")
    got = ca.admm_wave_cuda(*wargs, pb=1, cluster=2, **kw)
    held_bitwise("K2 relaxation N=26 B=300 resident vs staged", got[0],
                 ref[0])
    held_bitwise("K2 probe N=26 B=300 resident vs staged", got[1], ref[1])
    compare_probe("K2 N=26 B=300 streamed vs staged",
                  ca.admm_wave_cuda(*wargs, streamed=True, **kw),
                  ca.admm_wave_cuda(*wargs, streamed=False, **kw), qp,
                  lb[:300], ub[:300], s2, "large")

    # the main paths' shapes at N=27
    _, qp, spec, spec_p, f, h, lb, ub = problem(27, 4096, dev, rng)
    kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
    args = (kq, f, h, lb, ub)
    pl, _ = plan_line("N=27", kq, 4096, wave=False)
    forced = l2(kq, pl)
    got = ca.admm_solve_cuda(*args, iters=100)
    compare("K1 N=27 B=4096 100 it", got,
            ca.admm_solve_plain(*args, iters=100), r1, "large")
    held_bitwise("K1 N=27 B=4096 100 it", got, ca.admm_solve_cuda(
        *args, iters=100, **forced))
    work = admm_work(kq.n_pad, kq.m_pad, 4096, products=101, stats=1,
                     warm=False)
    r1["bound_by"] = timed(r1, "", lambda: ca.admm_solve_cuda(*args,
                                                              iters=100),
                           lambda: ca.admm_solve_plain(*args, iters=100),
                           work)
    print("  the same, L2-streamed:", flush=True)
    s1["bound_by"] = timed(s1, "", lambda: ca.admm_solve_cuda(
        *args, iters=100, **forced),
        lambda: ca.admm_solve_plain(*args, iters=100), work)
    r1["library_ms"] = s1["library_ms"] = None
    _, qp, spec, spec_p, f, h, lb, ub = problem(27, 32, dev, rng,
                                                 fix_frac=0.3)
    kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
    wargs = (kq, kq2, qp.binary_idx, f, h, lb, ub)
    kw = dict(iters=200, probe_iters=200)
    pl, _ = plan_line("N=27", kq, 32)
    forced = l2(kq, pl)
    ref = ca.admm_wave_plain(*wargs, **kw)
    warm = (ref[0].x, ref[0].z, ref[0].y)
    got = ca.admm_wave_cuda(*wargs, warm=warm, **kw)
    compare_probe("K2 N=27 B=32 200+100/100 it warm", got,
                  ca.admm_wave_plain(*wargs, warm=warm, **kw), qp, lb, ub, r2,
                  "large")
    st = ca.admm_wave_cuda(*wargs, warm=warm, **forced, **kw)
    held_bitwise("K2 relaxation N=27 B=32", got[0], st[0])
    held_bitwise("K2 probe N=27 B=32", got[1], st[1])
    work = admm_work(kq.n_pad, kq.m_pad, 32, products=402, stats=2, warm=True,
                     stiff=True, outputs=2)
    r2["bound_by"] = timed(
        r2, "", lambda: ca.admm_wave_cuda(*wargs, warm=warm, **kw),
        lambda: ca.admm_wave_plain(*wargs, warm=warm, **kw), work)
    print("  the same, L2-streamed:", flush=True)
    s2["bound_by"] = timed(
        s2, "", lambda: ca.admm_wave_cuda(*wargs, warm=warm, **forced, **kw),
        lambda: ca.admm_wave_plain(*wargs, warm=warm, **kw), work)
    r2["library_ms"] = s2["library_ms"] = None


def torch_equal(a, b):
    import torch

    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("x", "z", "y", "obj"))


def phase_split(dev, rng, rec):
    """K1 in split mode (the split-precision phase above N=21) against its
    plain version: after ONE split iteration from the plain version's
    iterates, on the whole solve's obj and x, at N=22, 24 and 27; the
    bench's gate (low_frac=1.0 against full-precision K1, 1e-4) at N=24;
    and its time at the sweep's shape (N=27, B=4096, 100 iterations)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    print("K1 split mode (admm_k1_split) vs plain; at N=27 resident, held "
          "bitwise against the L2-streamed variant:", flush=True)
    for N in SPLIT_HORIZONS:
        _, qp, spec, _, f, h, lb, ub = problem(N, 300, dev, rng)
        kq = ca.kernel_qp_for(spec)
        kq16 = ca.pad_kernel_qp(kq)
        check(ca.split_route(kq16.n_pad, kq16.m_pad) == "k1_split",
              f"N={N}: low_frac must route to K1's split mode")
        m, n = spec.m_ineq, spec.n
        packed = ca._pack(kq16, f, h, lb, ub, None)[:5]
        cold = ca._init_iterates(*packed[1:], None)
        it = tuple(t.contiguous() for t in
                   ca._mixed_plain(kq16, *packed, cold, MIXED_WARM[0]))
        ref = ca._mixed_plain(kq16, *packed, it, 1)
        got = ca.admm_solve_cuda(kq, f, h, lb, ub, iters=1, warm=it,
                                 low_frac=1.0)
        held(f"N={N} B=300 one split iteration after {MIXED_WARM[0]} "
             f"(plan {ca.plan(300, kq16.n_pad, kq16.m_pad)})",
             "mixed_iterates",
             dict(zG=(got.z[:, :m], ref[0][:, :m]),
                  yG=(got.y[:, :m], ref[1][:, :m]),
                  zB=(got.z[:, m:], ref[2][:, :n]),
                  yB=(got.y[:, m:], ref[3][:, :n])))
        args = (kq, f, h, lb, ub)
        for lf in (0.8, 1.0):
            compare(f"N={N} B=300 100 it low_frac={lf}",
                    ca.admm_solve_cuda(*args, iters=100, low_frac=lf),
                    ca.admm_solve_plain(*args, iters=100, low_frac=lf), rec,
                    "mixed")
        if N == 24:
            full = ca.admm_solve_cuda(*args, iters=100)
            got = ca.admm_solve_cuda(*args, iters=100, low_frac=1.0)
            gate = float(((got.obj - full.obj).abs()
                          / torch.clamp_min(full.obj.abs(), 1.0)).max())
            print(f"  N=24 B=300: low_frac=1.0 vs full-precision K1, max "
                  f"relative objective delta {gate:.2e} (gate "
                  f"{MIXED_GATE:.0e})", flush=True)
            check(gate <= MIXED_GATE, f"split gate: {gate:.3e} > "
                  f"{MIXED_GATE}")
            rec["n24_gate"] = gate
    # the sweep's shape
    _, qp, spec, _, f, h, lb, ub = problem(27, 4096, dev, rng)
    kq = ca.kernel_qp_for(spec)
    args = (kq, f, h, lb, ub)
    compare("N=27 B=4096 100 it low_frac=1.0",
            ca.admm_solve_cuda(*args, iters=100, low_frac=1.0),
            ca.admm_solve_plain(*args, iters=100, low_frac=1.0), rec,
            "mixed")
    kq16 = ca.pad_kernel_qp(kq)
    pl, _ = plan_line("N=27 split mode", kq16, 4096, wave=False, split=True)
    forced = l2(kq16, pl)
    for lf in (0.5, 1.0):
        held_bitwise(f"K1 split mode N=27 B=4096 low_frac={lf}",
                     ca.admm_solve_cuda(*args, iters=100, low_frac=lf),
                     ca.admm_solve_cuda(*args, iters=100, low_frac=lf,
                                        **forced))
    rec["bound_by"] = timed(
        rec, "", lambda: ca.admm_solve_cuda(*args, iters=100, low_frac=1.0),
        lambda: ca.admm_solve_plain(*args, iters=100, low_frac=1.0),
        admm_work(kq.n_pad, kq.m_pad, 4096, products=1, stats=1,
                  warm=False, lo_products=100))
    rec["streamed_kernel_ms"] = kernel_ms(lambda: ca.admm_solve_cuda(
        *args, iters=100, low_frac=1.0, **forced))
    print(f"  N=27 split mode, L2-streamed at the same tile: kernel alone "
          f"{rec['streamed_kernel_ms']:.3f} ms", flush=True)
    rec["library_ms"] = None
    return args


# The two-phase precision schedule (ops.admm.admm_solve_mixed) at the
# bench's mixed-section shape (bench.py:296-330: N=20, B=4096, 100
# iterations) at the reference's low_frac range, and at N=27 (K1's split
# mode); BoxQP.precision "high" and "default" (the one-pass split phase)
# at the same shapes; admm_solve_batch at config 1's shape. low_frac=1.0
# leaves no tail, and there, as in the reference, the schedule is one
# full-precision solve.
SCHEDULE_ITERS = 100
SCHEDULE_LOW_FRAC = (0.8, 1.0)


def one_pass_iterates(tag, kq, args, k0):
    """The one-pass split phase's own outputs after ONE iteration from the
    plain version's iterates after ``k0`` of them, against the plain
    version's ("mixed_iterates_1pass"): the tensor-core kernel where
    ``split_route`` takes it, else K1's split mode (one iteration, no
    tail)."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    kq16 = ca.pad_kernel_qp(kq)
    packed = ca._pack(kq16, *args, None)[:5]
    cold = ca._init_iterates(*packed[1:], None)
    it = tuple(t.contiguous() for t in
               ca._mixed_plain(kq16, *packed, cold, k0, passes=1))
    ref = ca._mixed_plain(kq16, *packed, it, 1, passes=1)
    m, n = kq.base.m_ineq, kq.base.n
    if ca.split_route(kq16.n_pad, kq16.m_pad) == "tensor_cores":
        got = ca._launch_k1_mixed(kq16, *packed, it, 1, passes=1)
        pairs = dict(zip(("zG", "yG", "zB", "yB"), zip(got, ref)))
    else:
        r = ca.admm_solve_cuda(kq, *args, iters=1, warm=it, low_frac=1.0,
                               lo_passes=1)
        pairs = dict(zG=(r.z[:, :m], ref[0][:, :m]),
                     yG=(r.y[:, :m], ref[1][:, :m]),
                     zB=(r.z[:, m:], ref[2][:, :n]),
                     yB=(r.y[:, m:], ref[3][:, :n]))
    held(f"{tag} one one-pass iteration after {k0}", "mixed_iterates_1pass",
         pairs)


def phase_mixed_schedule(dev, rng, recs):
    """The entry points of the mixed schedule on the card, one path
    (``mixed_schedule``): ``admm_solve_mixed`` at N=20, B=4096, 100
    iterations, low_frac 0.8 (the tensor-core split phase, then K1's tail)
    and 1.0 (one full-precision K1 solve), and at N=27, low_frac 0.8 (K1's
    split mode and its tail in one launch); ``BoxQP.precision`` "high" at
    N=20 and "default" (the one-pass split phase) at N=20 and N=27;
    ``admm_solve_batch`` at config 1's shape (N=10, one state's 1-D q over
    the 2^10 boxes of enumeration, 400 iterations). Then each launch held
    against its plain version ("mixed" for three passes, "mixed_1pass" for
    one, "main" at full precision), the one-pass kernels' own outputs after
    one iteration ("mixed_iterates_1pass"), the objectives against a
    full-precision K1 solve of the same problems beside the bench's 1e-4
    gate (a reading), and each case timed beside its bound."""
    import dataclasses

    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.ops.admm import (
        admm_solve_batch, admm_solve_mixed)
    from pyhybridcontrol_tpu_torch.solver.enumerate import _all_assignments

    print("the mixed schedule and BoxQP.precision (path mixed_schedule):",
          flush=True)
    it = SCHEDULE_ITERS
    _, _, s20, _, *a20 = problem(20, 4096, dev, rng)
    _, _, s27, _, *a27 = problem(27, 4096, dev, rng)
    _, qp10, s10, _, f10, h10, _, _ = problem(10, 1, dev, rng)
    asg = torch.as_tensor(_all_assignments(qp10.n_binary), device=dev)
    B10 = asg.shape[0]
    bidx = torch.as_tensor(qp10.binary_idx, device=dev)
    lb10 = qp10.lb.expand(B10, qp10.n).clone()
    ub10 = qp10.ub.expand(B10, qp10.n).clone()
    lb10[:, bidx] = asg
    ub10[:, bidx] = asg
    q10, h1 = f10[0], h10[0]
    a10 = (q10.expand(B10, -1), h1.expand(B10, -1), lb10, ub10)

    def at(spec, precision):
        return dataclasses.replace(spec, precision=precision, cache={})

    hi20, one20, one27 = at(s20, "high"), at(s20, "default"), at(s27,
                                                                 "default")
    kq20, kq27, kq10 = (ca.kernel_qp_for(s) for s in (s20, s27, s10))
    # case: (entry-point call, plain version, regime, bound's work)
    cases = {
        "N=20 low_frac=0.8": (
            lambda: admm_solve_mixed(s20, *a20, iters=it, low_frac=0.8),
            lambda: ca.admm_solve_plain(kq20, *a20, iters=it, low_frac=0.8),
            "mixed", admm_work(kq20.n_pad, kq20.m_pad, 4096, products=21,
                               stats=1, warm=False, lo_products=80)),
        "N=20 low_frac=1.0": (
            lambda: admm_solve_mixed(s20, *a20, iters=it, low_frac=1.0),
            lambda: ca.admm_solve_plain(kq20, *a20, iters=it),
            "main", admm_work(kq20.n_pad, kq20.m_pad, 4096, products=it + 1,
                              stats=1, warm=False)),
        "N=27 low_frac=0.8": (
            lambda: admm_solve_mixed(s27, *a27, iters=it, low_frac=0.8),
            lambda: ca.admm_solve_plain(kq27, *a27, iters=it, low_frac=0.8),
            "mixed", admm_work(kq27.n_pad, kq27.m_pad, 4096, products=21,
                               stats=1, warm=False, lo_products=80)),
        'N=20 precision="high"': (
            lambda: ca.admm_solve_auto(hi20, *a20, iters=it),
            lambda: ca.admm_solve_plain(kq20, *a20, iters=it, low_frac=1.0),
            "mixed", admm_work(kq20.n_pad, kq20.m_pad, 4096, products=1,
                               stats=1, warm=False, lo_products=it)),
        'N=20 precision="default"': (
            lambda: ca.admm_solve_auto(one20, *a20, iters=it),
            lambda: ca.admm_solve_plain(kq20, *a20, iters=it, low_frac=1.0,
                                        lo_passes=1),
            "mixed_1pass", admm_work(kq20.n_pad, kq20.m_pad, 4096,
                                     products=1, stats=1, warm=False,
                                     lo_products=it, lo_passes=1)),
        'N=27 precision="default"': (
            lambda: ca.admm_solve_auto(one27, *a27, iters=it),
            lambda: ca.admm_solve_plain(kq27, *a27, iters=it, low_frac=1.0,
                                        lo_passes=1),
            "mixed_1pass", admm_work(kq27.n_pad, kq27.m_pad, 4096,
                                     products=1, stats=1, warm=False,
                                     lo_products=it, lo_passes=1)),
        "N=10 B=1024 admm_solve_batch, 1-D q": (
            lambda: admm_solve_batch(s10, q10, h1, lb10, ub10, iters=400),
            lambda: ca.admm_solve_plain(kq10, *a10, iters=400),
            "main", admm_work(kq10.n_pad, kq10.m_pad, B10, products=401,
                              stats=1, warm=False)),
    }
    got, _ = drive("mixed_schedule",
                   lambda: {k: c[0]() for k, c in cases.items()})
    want = {**dict.fromkeys(ca.LAUNCHES, 0), "admm_k1": 5,
            "admm_k1_mixed": 2, "admm_k1_mixed_1pass": 1,
            "admm_k1_resident": 2, "admm_k1_split": 1,
            "admm_k1_split_1pass": 1}
    check(PATH_LAUNCHES["mixed_schedule"] == want,
          f"mixed_schedule: launches {PATH_LAUNCHES['mixed_schedule']}, "
          f"want {want}")
    # each launch against its plain version; the one-pass kernels' own
    # outputs after one iteration
    keys = {'N=20 precision="default"': "admm_k1_mixed_1pass",
            'N=27 precision="default"': "admm_k1_split_1pass",
            "N=27 low_frac=0.8": "admm_k1_split",
            "N=20 low_frac=1.0": "admm_k1",
            "N=10 B=1024 admm_solve_batch, 1-D q": "admm_k1"}
    for case, (_, plain, regime, _) in cases.items():
        compare(f"{case}, {it if 'N=10' not in case else 400} it",
                got[case], plain(), recs[keys.get(case, "admm_k1_mixed")],
                regime)
    for k0 in MIXED_WARM:
        one_pass_iterates("N=20 B=4096", kq20, a20, k0)
        one_pass_iterates("N=27 B=4096", kq27, a27, k0)
    # the bench's gate, as a reading: objectives against full precision
    full = {20: got["N=20 low_frac=1.0"],
            27: ca.admm_solve_cuda(kq27, *a27, iters=it)}
    gate = {}
    for case in ("N=20 low_frac=0.8", "N=27 low_frac=0.8",
                 'N=20 precision="high"', 'N=20 precision="default"',
                 'N=27 precision="default"'):
        ref = full[27 if case.startswith("N=27") else 20]
        gate[case] = float(((got[case].obj - ref.obj).abs()
                            / torch.clamp_min(ref.obj.abs(), 1.0)).max())
        print(f"  {case}: max relative objective delta against "
              f"full-precision K1 {gate[case]:.2e} (the bench's gate "
              f"{MIXED_GATE:.0e}; a reading)", flush=True)
    out = dict(gate=gate, launches=PATH_LAUNCHES["mixed_schedule"])
    if not TIMINGS:
        return out
    for case, (call, plain, _, work) in cases.items():
        r = out[case] = dict(ms=cuda_ms(call), kernel_ms=kernel_ms(call),
                             plain_ms=cuda_ms(plain))
        r["bound_ms"], r["bound_by"] = bound(*work)
        print(f"  {case}: wrapper {r['ms']:.3f} ms, kernels alone "
              f"{r['kernel_ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    recs["admm_k1_mixed"]["mixed_schedule"] = out
    for case, key in (('N=20 precision="default"', "admm_k1_mixed_1pass"),
                      ('N=27 precision="default"', "admm_k1_split_1pass")):
        recs[key].update(out[case], shape=f"{case}, B=4096, {it} it",
                         library_ms=None)
    return out


CL_SPEC = dict(capacity=256, wave_size=32, max_waves=48, qp_iters=200)
CL_T = 20           # config 1 of the reference bench: T=20 from [2, 0]
CL_T27 = 4


def closed_loop_steps(N, dev):
    """Config 1's bench step at horizon N (B&B with the probe prepared at
    ρ=10) and the enumeration step that holds it, on the card."""
    from pyhybridcontrol_tpu_torch.loop import make_mpc_step
    from pyhybridcontrol_tpu_torch.models import (
        di_default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    model = switched_double_integrator()
    c = CondensedMpc(model, N, di_default_weights())
    qp, admm = c.device_qp(dev), prepare_admm_mpc(c, device=dev)
    step = make_mpc_step(model, qp, admm, method="bnb",
                         bnb_spec=BnbSpec(**CL_SPEC),
                         admm_probe=prepare_admm_mpc(c, rho=10.0,
                                                     device=dev))
    return model, step, (model, qp, admm)


def phase_closed_loop(dev):
    """Config 1 of the reference bench as the port runs it: the switched
    double integrator, N=10, T=20 from [2, 0], B&B with capacity 256, wave
    32, 48 waves, 200 iterations and the probe at ρ=10. ms per control
    step (host clock around a run that ends in a synchronise, best of 3
    after a warm-up), found share, mean nodes; held against the port's
    enumeration loop on the card (600 iterations): total cost within
    rtol 2e-3, states within 1e-2."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.loop import closed_loop, make_mpc_step

    print("closed loop, config 1 (N=10, T=20):", flush=True)
    model, step, (m, qp, admm) = closed_loop_steps(10, dev)
    x0 = [2.0, 0.0]
    closed_loop(model, step, x0, T=2)                 # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, _ = drive("closed_loop_config1",
                       lambda: closed_loop(model, step, x0, T=CL_T))
        times.append(time.perf_counter() - t0)
    ms = 1e3 * min(times) / CL_T
    check(PATH_LAUNCHES["closed_loop_config1"]["admm_k2"] > 0,
          "closed loop: K2 was never launched")
    found = float(res.found.float().mean())
    nodes = float(res.nodes.float().mean())
    print(f"  {ms:.2f} ms per control step (runs of "
          f"{', '.join(f'{1e3 * t:.1f}' for t in times)} ms for {CL_T} "
          f"steps), found share {found:.3f}, mean nodes {nodes:.1f}",
          flush=True)
    enum = make_mpc_step(m, qp, admm, method="enumerate", qp_iters=600)
    ref = closed_loop(model, enum, x0, T=CL_T)
    tot, tot_ref = float(res.objs.sum()), float(ref.objs.sum())
    dx = float((res.xs - ref.xs).abs().max())
    print(f"  total cost {tot:.4f}, enumeration {tot_ref:.4f} (rel "
          f"{abs(tot - tot_ref) / abs(tot_ref):.2e}, limit 2e-3); max |Δx| "
          f"{dx:.2e} (limit 1e-2 + 1e-2·|x|)", flush=True)
    check(bool(res.found.all()), "closed loop: a step without a plan")
    check(abs(tot - tot_ref) <= 2e-3 * abs(tot_ref),
          f"closed loop: total cost {tot} vs enumeration {tot_ref}")
    check(np.allclose(res.xs.cpu().numpy(), ref.xs.cpu().numpy(),
                      rtol=1e-2, atol=1e-2),
          f"closed loop: states off enumeration's by {dx}")
    return dict(ms_per_control_step=ms, found_frac=found, mean_nodes=nodes,
                run_ms=[1e3 * t for t in times], total_cost=tot,
                total_cost_enumeration=tot_ref)


def phase_closed_loop_n27(dev, sweep_args, rec):
    """The N=27 double integrator, whose constants no block can stage: a
    short closed loop (T=4, config 1's B&B spec, K2 resident) that must
    find every step, follow the dynamics and move the state toward the
    origin; then the relaxation sweep at low_frac=1.0 (K1 resident, in
    split mode), held against its plain version."""
    import torch

    from pyhybridcontrol_tpu_torch.loop import closed_loop
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    print(f"closed loop, N=27 (T={CL_T27}):", flush=True)
    model, step, _ = closed_loop_steps(27, dev)
    x0 = [2.0, 0.0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, batches = drive("closed_loop_N27",
                         lambda: closed_loop(model, step, x0, T=CL_T27))
    ms = 1e3 * (time.perf_counter() - t0) / CL_T27
    got = PATH_LAUNCHES["closed_loop_N27"]
    check(got["admm_k2_resident"] > 0 and got["admm_k2"] == 0,
          f"closed loop N=27: K2 must run resident, launches {got}")
    md = model.to(dev)
    for k in range(CL_T27):
        want = md.step_v(res.xs[k], res.vs[k])
        check(bool(torch.allclose(res.xs[k + 1], want, rtol=1e-5,
                                  atol=1e-6)),
              f"closed loop N=27: step {k} does not follow the dynamics")
    check(bool(res.found.all()), "closed loop N=27: a step without a plan")
    norms = res.xs.norm(dim=-1).tolist()
    check(norms[-1] < norms[0], f"closed loop N=27: |x| {norms}")
    print(f"  {ms:.1f} ms per control step, nodes "
          f"{res.nodes.tolist()}, |x| {[round(v, 4) for v in norms]}, "
          f"objectives {[round(v, 3) for v in res.objs.tolist()]}",
          flush=True)
    sweep, _ = drive("relax_sweep_N27_low_frac", lambda: ca.admm_solve_cuda(
        *sweep_args, iters=100, low_frac=1.0))
    check(PATH_LAUNCHES["relax_sweep_N27_low_frac"] == {
        **dict.fromkeys(ca.LAUNCHES, 0), "admm_k1_resident": 1,
        "admm_k1_split": 1}, f"N=27 sweep: launches "
        f"{PATH_LAUNCHES['relax_sweep_N27_low_frac']}")
    compare("N=27 sweep low_frac=1.0", sweep, ca.admm_solve_plain(
        *sweep_args, iters=100, low_frac=1.0), rec, "mixed")
    return dict(ms_per_control_step=ms, nodes=res.nodes.tolist(),
                total_cost=float(res.objs.sum()))


PATH_LAUNCHES = {}   # path -> launch counts of that path alone
PATH_BATCHES = {}    # path -> {kernel: {batch size: launches}} of that path


def drive(path, fn):
    """Run one path with the launch counts set to 0 just before it and
    read just after it. Returns (what fn returned, batch sizes per
    kernel)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    check(path in PATHS, f"drive: {path} is not a path")
    ca.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    PATH_LAUNCHES[path] = dict(ca.LAUNCHES)
    batches = {k: dict(v) for k, v in ca.LAUNCH_BATCHES.items() if v}
    PATH_BATCHES[path] = batches
    print(f"  launches on {path}: {PATH_LAUNCHES[path]}, batch sizes "
          f"{batches}", flush=True)
    return out, batches


def phase_serve_batch(dev, sweep_args):
    """The batched serving path: one 1024-instance request through the
    serve loop (pooled B&B, K2 at B=1024); the reference bench's config-4
    call from nothing and with carried incumbents (probe-gated waves:
    K1); the split-precision relaxation sweep. Each is a path with launch
    counts of its own."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch import serve
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec
    from pyhybridcontrol_tpu_torch.solver.bnb_pooled import (
        solve_miqp_bnb_pooled)

    print("serve --config scenario_batch --device cuda:", flush=True)
    t0 = time.perf_counter()
    ctrl, ready = serve.build_controller("scenario_batch", "bnb", dev.type)
    print(f"  controller built + warmup solve: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    x0s = np.random.default_rng(SEED).normal(size=(BATCH, 2)).astype(
        np.float32)
    drawn = x0s[BATCH_OUT_OF_BOX].copy()
    x0s[BATCH_OUT_OF_BOX] = OUT_OF_BOX
    lines = [json.dumps({"x": x0s.tolist(), "id": "batch"}),
             '{"cmd": "quit"}']
    out = io.StringIO()
    _, batches = drive("serve_batch_request", lambda: serve.stdin_loop(
        ctrl, ready, inp=io.StringIO("\n".join(lines) + "\n"), out=out))
    served = PATH_LAUNCHES["serve_batch_request"]
    replies = [json.loads(s) for s in out.getvalue().splitlines()]
    check(len(replies) == 2 and replies[0].get("ready") is True,
          "serve_batch: expected a ready line and one reply")
    r = replies[1]
    check("error" not in r, f"serve_batch: error reply {r}")
    check(r["batch"] == BATCH and r["id"] == "batch",
          "serve_batch: batch/id not echoed")
    for k in ("u", "delta", "obj", "found"):
        check(isinstance(r[k], list) and len(r[k]) == BATCH,
              f"serve_batch: {k} is not a list of {BATCH}")
    obj, found = np.asarray(r["obj"]), np.asarray(r["found"])
    check(not found[BATCH_OUT_OF_BOX],
          "serve_batch: the out-of-box instance must be found=false")
    check(bool(np.isfinite(obj[found]).all()), "serve_batch: non-finite obj")
    print(f"  request of {BATCH}: {r['ms']} ms, {r['ms'] / BATCH:.4f} ms per "
          f"instance, found share {found.mean():.4f}", flush=True)
    check(served["admm_k2"] > 0, "serve_batch: K2 was never launched")
    check(set(batches["admm_k2"]) == {BATCH},
          f"serve_batch: K2 launches not all at B={BATCH}: {batches}")

    enum = MpcController(ctrl.model, ctrl.N, ctrl.weights,
                         solver="enumerate", qp_iters=600, device=dev)
    diffs, refs = [], []
    for i in BATCH_SAMPLE:
        ref = enum.feedback(x0s[i])
        check(bool(ref.found) == bool(found[i]),
              f"serve_batch: instance {i} found={found[i]}, enumeration "
              f"{bool(ref.found)}")
        if found[i]:
            diffs.append(abs(obj[i] - float(ref.obj)))
            refs.append(float(ref.obj))
    serve_reading(f"serve_batch, {len(diffs)} sampled instances vs "
                  f"enumeration", diffs, refs)

    # the reference bench's config-4 call: no seed, gated probes, pool 8·B,
    # on the states as the bench draws them (all inside the box: the gate
    # closes only once EVERY instance has an incumbent)
    spec4 = BnbSpec(capacity=1024, wave_size=1024, max_waves=4096,
                    qp_iters=100, probe_patience=3)
    x0s_bench = x0s.copy()
    x0s_bench[BATCH_OUT_OF_BOX] = drawn
    others = np.arange(BATCH) != BATCH_OUT_OF_BOX   # compared on these
    f, h = ctrl._qp.assemble(torch.as_tensor(x0s_bench, device=dev))

    def solve4(seed=None):
        return solve_miqp_bnb_pooled(ctrl._admm, ctrl._qp, f, h, spec4,
                                     pool_slots=8 * BATCH,
                                     init_incumbent=seed,
                                     admm_probe=ctrl._admm_probe)

    def timed4(path, tag, seed=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, batches = drive(path, lambda: solve4(seed))
        ms = 1e3 * (time.perf_counter() - t0)
        k1 = PATH_LAUNCHES[path]["admm_k1"]
        check(PATH_LAUNCHES[path]["admm_k2"] + k1 == res.waves,
              f"pooled call: {res.waves} waves, launches "
              f"{PATH_LAUNCHES[path]}")
        check(all(set(b) == {BATCH} for b in batches.values()),
              f"pooled call: launches not all at B={BATCH}: {batches}")
        nodes = int(res.nodes_solved)
        found4 = res.found.cpu().numpy()
        both = found & found4 & others
        dobj = np.where(both, np.abs(res.obj.cpu().numpy() - obj), 0.0)
        print(f"  solve_miqp_bnb_pooled (wave 1024, probe_patience=3, pool "
              f"8·B{tag}): {ms:.1f} ms, {res.waves} waves, {nodes} nodes, "
              f"{1e3 * BATCH / ms:.1f} MIQP/s, {1e3 * nodes / ms:.0f} "
              f"nodes/s, found share {found4.mean():.4f}, overflow "
              f"{bool(res.overflow)}, K1 launches (gated waves) {k1}",
              flush=True)
        check(bool((found4 == found)[others].all()) and
              bool(found4[BATCH_OUT_OF_BOX]),
              "pooled call: found differs from the served request")
        serve_reading(f"pooled call{tag} vs the request", dobj[both],
                      obj[both])
        return res, k1

    solve4()                                   # warm-up, as the bench's
    # The gate closes after probe_patience waves in which NO instance found
    # a better incumbent. With 1024 instances searching from nothing some
    # probe improves in nearly every wave, so this call gates no wave and
    # launches K1 no time, here as in the reference (its pooled engine with
    # the Pallas kernels in interpret mode gates none of its 38 waves on
    # these states: tests/test_torch_pooled.py holds the two together).
    # The count is printed as measured and not checked.
    res, _ = timed4("pooled_bench_spec", "")
    # A re-solve that carries its incumbents (a receding-horizon step does)
    # finds few better ones, so some of its probes are gated and those
    # waves run K1 alone. How many is up to the data: 4 of 38 waves on the
    # states of seed 0, where it is checked; 0-4 on those of seeds 1-7,
    # where the count is printed as measured.
    _, k1 = timed4("pooled_carried_incumbents", ", incumbents carried",
                   (res.obj, res.x, res.found))
    check(k1 > 0 or SEED != 0,
          "pooled call: K1 never launched on the gated waves")

    # the relaxation sweep that uses the split-precision phase
    sweep, _ = drive("relax_sweep_low_frac", lambda: ca.admm_solve_cuda(
        *sweep_args, iters=100, low_frac=1.0))
    check(bool(torch.isfinite(sweep.obj).all()), "relax sweep: non-finite")
    check(PATH_LAUNCHES["relax_sweep_low_frac"] == {
        **dict.fromkeys(ca.LAUNCHES, 0), "admm_k1": 1, "admm_k1_mixed": 1},
          f"relax sweep: launches {PATH_LAUNCHES['relax_sweep_low_frac']}")


def phase_serve(dev):
    from pyhybridcontrol_tpu_torch import serve
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController

    print("serve --config double_integrator --device cuda:", flush=True)
    t0 = time.perf_counter()
    ctrl, ready = serve.build_controller("double_integrator", "bnb",
                                         dev.type)
    print(f"  controller built + warmup solve: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    lines = ['{"cmd": "ping"}']
    lines += [json.dumps({"x": x, "id": i}) for i, x in enumerate(STATES)]
    lines += [json.dumps({"x": OUT_OF_BOX, "id": "out_of_box"}),
              '{"cmd": "quit"}']
    out = io.StringIO()
    drive("serve_config1", lambda: serve.stdin_loop(
        ctrl, ready, inp=io.StringIO("\n".join(lines) + "\n"), out=out))
    launches = PATH_LAUNCHES["serve_config1"]
    replies = [json.loads(s) for s in out.getvalue().splitlines()]
    check(replies[0].get("ready") is True, "serve: no ready line")
    check(replies[1] == {"pong": True}, "serve: ping not answered")
    check(len(replies) == 2 + len(STATES) + 1, "serve: missing replies")
    check(launches["admm_k2"] > 0, "serve: K2 was never launched")

    enum = MpcController(ctrl.model, ctrl.N, ctrl.weights,
                         solver="enumerate", qp_iters=600, device=dev)
    diffs, refs = [], []
    for x, r in zip(STATES, replies[2:2 + len(STATES)]):
        check("error" not in r, f"serve: error reply {r}")
        ref = enum.feedback(x)
        check(r["found"] and bool(ref.found), f"serve: x0={x} not found")
        d = abs(r["obj"] - float(ref.obj))
        print(f"  x0={x}: obj={r['obj']:.6f} enumeration="
              f"{float(ref.obj):.6f} |Δ|={d:.2e} ms={r['ms']}", flush=True)
        diffs.append(d)
        refs.append(float(ref.obj))
    serve_reading("serve vs enumeration", diffs, refs)
    bad = replies[-1]
    check("error" not in bad and bad["found"] is False,
          f"serve: out-of-box state must come back found=false, got {bad}")
    print(f"  x0={OUT_OF_BOX}: found=false ms={bad['ms']}", flush=True)


# K2 (and K1 on probe-gated waves) at the shapes the real frames' paths give
# them: (config, wave size B, relaxation iterations, probe iterations, gated
# waves on that path, the relaxation's regime). The relaxations are held to
# the "main" limits, the probes to "wave_probe". Config 2 at B=64, 400 +
# 400 is the served request's wave: there the plain version's own
# relaxation is 3.6e-4 to 7.8e-4 from fp64 in x, above "main"'s 4e-4, and a
# one-ulp change of q moves it by 1.5e-4 to 2.5e-4 (tools/plain_noise.py
# --served, seeds 0-7, CPU), so its relaxation is held to "wave_probe", the
# limits of the real frames' waves whose plain version is itself that far
# from fp64 (and bitwise to the L2-streamed variant, as every shape). At 400
# iterations more hull binaries settle at 0.5: the plain version in float32
# rounds one otherwise than in float64 on 3.1% to 14.1% of the instances
# (same readings), so its probe is held where kernel and plain version
# round alike, on a share of flips 3x that reading (FLIP_SHARE_SERVED); the
# band (every flip within FLIP_BAND of 0.5) is unchanged.
FLIP_SHARE_SERVED = 0.42
PATH_SHAPES = (("config2", 128, 200, 600, True, "main", FLIP_SHARE_HULL,
                CERT_BAND),
               ("config3", 64, 200, 200, False, "main", FLIP_SHARE,
                CERT_BAND_CFG3),
               ("config4b", 1024, 150, 150, True, "main", FLIP_SHARE_4B,
                CERT_BAND),
               ("config2", 64, 400, 400, False, "wave_probe",
                FLIP_SHARE_SERVED, CERT_BAND))


def phase_streamed_paths(dev, rng, recs):
    """Resident K2 at the waves of the config-2 call (B=128, 200 + 600
    probe iterations), the served config-2 request (B=64, 400 + 400),
    config 3's loop (B=64, 200 + 200) and config 4b's pooled loop (B=1024,
    150 + 150), warm-started as every wave after the root is, and resident
    K1 on the probe-gated waves of configs 2 and 4b: each against its plain
    version on real node problems ("main" limits on the relaxations but the
    served shape's, "wave_probe" on the probes; PATH_SHAPES says why;
    certificate bits may differ near a
    threshold) and bitwise against the L2-streamed variant at the same
    tile, its plan, and both variants' times beside the bound."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    r1, r2 = recs["admm_k1_resident"], recs["admm_k2_resident"]
    s1, s2 = recs["admm_k1_streamed"], recs["admm_k2_streamed"]
    print("K1/K2 resident at the real frames' path shapes:", flush=True)
    for name, B, iters, piters, gated, regime, flips, band in PATH_SHAPES:
        spec, spec_p, bidx, q, h, lb, ub = real_problem(name, B, dev, rng)
        kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
        pl, cap = plan_line(name, kq, B)
        forced = l2(kq, pl)
        r2[f"{name}_B{B}_plan"] = dict(pb=pl.pb, cluster=pl.cluster,
                                       threads=pl.threads, smem=pl.smem,
                                       clusters_at_once=cap)
        args = (kq, q, h, lb, ub)
        wargs = (kq, kq2, bidx, q, h, lb, ub)
        kw = dict(iters=iters, probe_iters=piters)
        cold = ca.admm_wave_plain(*wargs, **kw)
        warm = (cold[0].x, cold[0].z, cold[0].y)
        tag = f"{name} B={B} {iters}+{piters} it warm"
        got = ca.admm_wave_cuda(*wargs, warm=warm, **kw)
        with cert_band(band):
            compare_probe("K2 " + tag, got,
                          ca.admm_wave_plain(*wargs, warm=warm, **kw),
                          types.SimpleNamespace(binary_idx=bidx), lb, ub, r2,
                          regime, flip_share=flips,
                          probe_regime="wave_probe", plain=args)
        st = ca.admm_wave_cuda(*wargs, warm=warm, **forced,
                               **kw)
        held_bitwise("K2 relaxation " + tag, got[0], st[0])
        held_bitwise("K2 probe " + tag, got[1], st[1])
        timed_variants(
            r2, s2, f"{name}_B{B}_wave_",
            lambda: ca.admm_wave_cuda(*wargs, warm=warm, **kw),
            lambda: ca.admm_wave_cuda(*wargs, warm=warm, **forced, **kw),
            lambda: ca.admm_wave_plain(*wargs, warm=warm, **kw),
            admm_work(kq.n_pad, kq.m_pad, B, products=iters + piters + 2,
                      stats=2, warm=True, stiff=True, outputs=2))
        # where the plan took a larger cluster for a wider tile, the time
        # of a tile of 1 over the smallest cluster that holds one
        C1 = ca.plan(1, kq.n_pad, kq.m_pad).cluster
        if pl.cluster != C1:
            key = f"{name}_B{B}_wave_C{C1}_tile1_kernel_ms"
            r2[key] = kernel_ms(lambda: ca.admm_wave_cuda(
                *wargs, warm=warm, pb=1, cluster=C1, **kw))
            print(f"  {name} B={B}: a tile of 1 over {C1} CTAs instead, "
                  f"kernel alone {r2[key]:.3f} ms", flush=True)
        if not gated:
            continue
        ref = ca.admm_solve_plain(*args, iters=iters, warm=warm)
        got = ca.admm_solve_cuda(*args, iters=iters, warm=warm)
        compare(f"K1 {name} B={B} {iters} it warm", got, ref, r1,
                near=lambda: cert_factor(args, ref))
        held_bitwise(f"K1 {name} B={B} {iters} it warm", got,
                     ca.admm_solve_cuda(*args, iters=iters, warm=warm,
                                        **forced))
        timed_variants(
            r1, s1, f"{name}_B{B}_gated_",
            lambda: ca.admm_solve_cuda(*args, iters=iters, warm=warm),
            lambda: ca.admm_solve_cuda(*args, iters=iters, warm=warm,
                                       **forced),
            lambda: ca.admm_solve_plain(*args, iters=iters, warm=warm),
            admm_work(kq.n_pad, kq.m_pad, B, products=iters + 1, stats=1,
                      warm=True))


def group_probe_boxes(qp, groups, lb, ub, x):
    """The pooled engine's probe boxes under a branch map: every binary of
    a group the node leaves free fixed to the rounded mean of the group's
    relaxed values (half to even), the node's fixed groups kept."""
    import numpy as np
    import torch

    dev = lb.device
    bidx = torch.as_tensor(qp.binary_idx, device=dev)
    g = torch.as_tensor(np.asarray(groups), device=dev)
    ng = int(g.max()) + 1
    Mavg = torch.zeros((len(groups), ng), device=dev)
    Mavg[torch.arange(len(groups), device=dev), g] = 1.0
    Mavg /= Mavg.sum(0, keepdim=True)
    mean = torch.round(torch.clamp(x[:, bidx] @ Mavg, 0.0, 1.0))[:, g]
    fixed = lb[:, bidx] == ub[:, bidx]
    val = torch.where(fixed, lb[:, bidx], mean)
    lbp, ubp = lb.clone(), ub.clone()
    lbp[:, bidx], ubp[:, bidx] = val, val
    return lbp, ubp


def phase_tree_shapes(dev, rng, recs):
    """Resident K1 at config 4c's pooled wave (bench.py:679-690: B=1024,
    warm): the relaxation (100 iterations) and the probe the pool runs
    under rep-map branching (every binary fixed to its group's rounded
    mean; 200 iterations at ρ·10, then 200 at ρ, warm from the
    relaxation); and resident K2 at the wave of a single-instance dense
    tree ``feedback`` (B=64, 100 + 200/200 iterations, per-coordinate
    rounding), and resident K1 at that tree's gated waves (B=64, 100
    iterations warm). Each against its plain version on config 4c's joint
    frame at group-fixed node boxes, all at the "main" limits (the plain
    version's own fp32-vs-fp64 difference on this probe is under a tenth
    of them: tools/plain_noise.py), and bitwise against the L2-streamed
    variant at the same tile, with its plan and both variants' times."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    r1, r2 = recs["admm_k1_resident"], recs["admm_k2_resident"]
    s1, s2 = recs["admm_k1_streamed"], recs["admm_k2_streamed"]
    print("K1/K2 resident at config 4c's waves:", flush=True)
    groups = config4c_groups()
    B = 1024
    spec, spec_p, bidx, q, h, lb, ub = real_problem("config4c", B, dev, rng)
    kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
    pl, cap = plan_line("config4c", kq, B, wave=False)
    forced = l2(kq, pl)
    r1["config4c_B1024_plan"] = dict(pb=pl.pb, cluster=pl.cluster,
                                     threads=pl.threads, smem=pl.smem,
                                     clusters_at_once=cap)
    args = (kq, q, h, lb, ub)
    cold = ca.admm_solve_plain(*args, iters=100)
    warm = (cold.x, cold.z, cold.y)
    ref = ca.admm_solve_plain(*args, iters=100, warm=warm)
    got = ca.admm_solve_cuda(*args, iters=100, warm=warm)
    compare(f"K1 config4c relaxation B={B} 100 it warm", got, ref, r1)
    held_bitwise(f"K1 config4c relaxation B={B}", got, ca.admm_solve_cuda(
        *args, iters=100, warm=warm, **forced))
    timed_variants(
        r1, s1, "config4c_relax_",
        lambda: ca.admm_solve_cuda(*args, iters=100, warm=warm),
        lambda: ca.admm_solve_cuda(*args, iters=100, warm=warm, **forced),
        lambda: ca.admm_solve_plain(*args, iters=100, warm=warm),
        admm_work(kq.n_pad, kq.m_pad, B, products=101, stats=1, warm=True))
    lbp, ubp = group_probe_boxes(types.SimpleNamespace(binary_idx=bidx),
                                 groups, lb, ub, ref.x)
    pw = (ref.x, ref.z, ref.y)

    def probe(solve, **kw):
        a = solve(kq2, q, h, lbp, ubp, iters=200, warm=pw, **kw)
        return a, solve(kq, q, h, lbp, ubp, iters=200, warm=(a.x, a.z, a.y),
                        **kw)

    got, want = probe(ca.admm_solve_cuda), probe(ca.admm_solve_plain)
    compare(f"K1 config4c probe B={B} 200 it at ρ·10 warm", got[0], want[0],
            r1)
    st = probe(ca.admm_solve_cuda, **forced)
    held_bitwise(f"K1 config4c probe B={B} at ρ·10", got[0], st[0])
    held_bitwise(f"K1 config4c probe B={B} then at ρ", got[1], st[1])
    # the base half from the same iterates, so that the comparison holds
    # one launch, not the drift of the first
    w1 = (want[0].x, want[0].z, want[0].y)
    compare(f"K1 config4c probe B={B} then 200 it at ρ warm",
            ca.admm_solve_cuda(kq, q, h, lbp, ubp, iters=200, warm=w1),
            want[1], r1)
    b1, o1 = admm_work(kq.n_pad, kq.m_pad, B, products=201, stats=1,
                       warm=True, stiff=True)
    b2, o2 = admm_work(kq.n_pad, kq.m_pad, B, products=201, stats=1,
                       warm=True)
    timed_variants(r1, s1, "config4c_probe_",
                   lambda: probe(ca.admm_solve_cuda),
                   lambda: probe(ca.admm_solve_cuda, **forced),
                   lambda: probe(ca.admm_solve_plain),
                   (b1 + b2, {"fp32": o1["fp32"] + o2["fp32"]}))

    Bw = CFG4C_SPEC["wave_size"]
    spec, spec_p, bidx, q, h, lb, ub = real_problem("config4c", Bw, dev, rng)
    kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
    pl, _ = plan_line("config4c", kq, Bw)
    forced = l2(kq, pl)
    wargs = (kq, kq2, bidx, q, h, lb, ub)
    kw = dict(iters=100, probe_iters=400)
    cold = ca.admm_wave_plain(*wargs, **kw)
    warm = (cold[0].x, cold[0].z, cold[0].y)
    got = ca.admm_wave_cuda(*wargs, warm=warm, **kw)
    compare_probe(f"K2 config4c B={Bw} 100+200/200 it warm", got,
                  ca.admm_wave_plain(*wargs, warm=warm, **kw),
                  types.SimpleNamespace(binary_idx=bidx), lb, ub, r2)
    st = ca.admm_wave_cuda(*wargs, warm=warm, **forced, **kw)
    held_bitwise(f"K2 relaxation config4c B={Bw}", got[0], st[0])
    held_bitwise(f"K2 probe config4c B={Bw}", got[1], st[1])
    timed_variants(
        r2, s2, "config4c_wave_",
        lambda: ca.admm_wave_cuda(*wargs, warm=warm, **kw),
        lambda: ca.admm_wave_cuda(*wargs, warm=warm, **forced, **kw),
        lambda: ca.admm_wave_plain(*wargs, warm=warm, **kw),
        admm_work(kq.n_pad, kq.m_pad, Bw, products=502, stats=2,
                  warm=True, stiff=True, outputs=2))
    # K1 on the same tree's gated single-instance waves (B=64, 100 it warm)
    args = (kq, q, h, lb, ub)
    got = ca.admm_solve_cuda(*args, iters=100, warm=warm)
    compare(f"K1 config4c gated wave B={Bw} 100 it warm", got,
            ca.admm_solve_plain(*args, iters=100, warm=warm), r1)
    held_bitwise(f"K1 config4c gated wave B={Bw}", got, ca.admm_solve_cuda(
        *args, iters=100, warm=warm, **forced))
    timed_variants(
        r1, s1, "config4c_gated_",
        lambda: ca.admm_solve_cuda(*args, iters=100, warm=warm),
        lambda: ca.admm_solve_cuda(*args, iters=100, warm=warm, **forced),
        lambda: ca.admm_solve_plain(*args, iters=100, warm=warm),
        admm_work(kq.n_pad, kq.m_pad, Bw, products=101, stats=1, warm=True))
    print(f"  resident vs L2-streamed so far: {BITWISE[0]} holds bitwise on "
          f"x, z, y; largest relative stats difference {BITWISE[1]:.2e}",
          flush=True)


CFG4C_B = 256
CFG4C_SPEC = dict(capacity=1024, wave_size=64, max_waves=64, qp_iters=100,
                  probe_iters=400, probe_patience=3)
# repetitions of the call (the same waves each; ~30 s each on the card)
CFG4C_REPS = 3
CFG4C_PLANS = tuple(range(0, CFG4C_B, 8))     # 32 plans held in fp64
CFG4C_HELD = tuple(range(0, CFG4C_B, 16))     # 16 held to single feedback
# the mean objective the reference recorded for this call
# (BENCH_DETAILS.json:101); printed beside the port's, not a limit
CFG4C_REF_MEAN_OBJ = -288.5737


def phase_config4c_call(dev, recs):
    """Config 4c of the reference bench (bench.py:654-701) on the card:
    256 states of default_rng(13) after its tree's paths, each one
    scenario-tree MIQP of the dense joint frame, through
    ``feedback_batch(engine="pooled", pooled_wave=1024, pool_slots=8·B)``
    with rep-map branching, 3 repetitions. Every K1 launch at B=1024 and
    no K2 launch; found share 1.0; 32 plans feasible in fp64 against the
    port's joint frame (G V ≤ h with the non-anticipativity rows, the box,
    binaries 0/1); 16 instances held to the port's single-instance
    ``feedback`` on the same tree (K2, per-coordinate branching), within
    1e-3 relative (floor 1), the reference's tolerance between its pooled
    and per-instance engines (tests/test_bnb_pooled.py), and never below
    the single search's certified bound by more. The two searches end on
    different leaves (the pooled rep-map search mostly on worse ones, also
    against single searches of 1024 waves: tools/tree_search_ab.py), so
    ``serve_limit`` is printed as a reading only.
    Tree-MIQP/s, mean objective, waves, nodes, and K1's share of the call
    reckoned from its launches and the kernel-alone times of
    ``phase_tree_shapes`` (``recs``)."""
    import numpy as np
    import torch

    import pyhybridcontrol_tpu_torch.control.mpc as mpc
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    tree, rng = config4c_tree()
    model, w, c = bench_frame("config4c")
    B = CFG4C_B
    print(f"config 4c call (B={B} trees, S={CFG4C_S}, N={CFG4C_N}, frame "
          f"{c.nV}/{c.G.shape[0]}, {len(c.binary_idx)} binaries in "
          f"{int(max(config4c_groups())) + 1} groups):", flush=True)
    ctrl = MpcController(model, CFG4C_N, w, device=dev)
    ctrl.set_scenario_tree(tree)
    ctrl.bnb_spec = BnbSpec(**CFG4C_SPEC)
    check(np.array_equal(ctrl.condensed.G, c.G),
          "config 4c: the controller's frame is not the bench's")
    x0s = rng.normal(size=(B, 2)).astype(np.float32)
    xs = torch.as_tensor(x0s, device=dev)
    results = []
    orig = mpc.solve_miqp_bnb_pooled

    def spy(*a, **kw):
        results.append(orig(*a, **kw))
        return results[-1]

    def solve():
        return ctrl.feedback_batch(xs, engine="pooled", pooled_wave=1024,
                                   pool_slots=8 * B)

    times = []
    mpc.solve_miqp_bnb_pooled = spy
    try:
        for rep in range(CFG4C_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if rep == 0:
                res, _ = drive("config4c_call", solve)
            else:
                res = solve()
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        mpc.solve_miqp_bnb_pooled = orig
    waves = results[0].waves
    check(all(r.waves == waves for r in results), "config 4c: repetitions "
          f"ran {[r.waves for r in results]} waves")
    got = PATH_LAUNCHES["config4c_call"]
    k1 = got["admm_k1_resident"]
    probing = (k1 - waves) // 2      # relaxation, + two probe halves
    path = ("unfused K1 relax + probe"
            if got["admm_k2"] + got["admm_k2_resident"] == 0 and k1 else
            "other")
    check(path == "unfused K1 relax + probe" and got["admm_k1"] == 0,
          f"config 4c: the waves must run resident K1 only, launches {got}")
    check(k1 == waves + 2 * probing and 0 < probing <= waves,
          f"config 4c: {k1} K1 launches in {waves} waves")
    launched_at("config4c_call", ("admm_k1_resident",), 1024)
    dt = sorted(times)[len(times) // 2]
    found = float(res.found.float().mean())
    objs = res.obj.double().cpu().numpy()
    nodes = int(res.nodes[0])
    r1 = recs["admm_k1_resident"]
    k1_s = 1e-3 * (waves * r1["config4c_relax_kernel_ms"]
                   + probing * r1["config4c_probe_kernel_ms"])
    print(f"  wave path: {path}; {[round(t, 3) for t in times]} s, median "
          f"{dt:.3f} s: {B / dt:.1f} tree-MIQP/s; {waves} waves ({probing} "
          f"probing, {waves - probing} gated), {nodes} nodes, {k1} K1 "
          f"launches, K1 ~{k1_s:.2f} s of the call ({100 * k1_s / dt:.0f}%, "
          f"launches × kernel-alone times), the rest pool machinery; found "
          f"share {found:.4f}; mean objective {objs.mean():.4f} (the "
          f"reference recorded {CFG4C_REF_MEAN_OBJ})", flush=True)
    check(found == 1.0, "config 4c: a tree without a plan")
    W = tree.omega_paths.reshape(-1, 1)
    plans_feasible("config 4c", c, [
        (res.v_seq[i].reshape(-1).double().cpu().numpy(), x0s[i], W, None)
        for i in CFG4C_PLANS])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single, _ = drive("config4c_feedback",
                      lambda: [ctrl.feedback(xs[i]) for i in CFG4C_HELD])
    ms1 = 1e3 * (time.perf_counter() - t0) / len(CFG4C_HELD)
    got1 = PATH_LAUNCHES["config4c_feedback"]
    check(got1["admm_k2_resident"] > 0 and got1["admm_k2"] == 0,
          f"config 4c feedback: K2 must run resident, launches {got1}")
    launched_at("config4c_feedback", ("admm_k2_resident",
                                      "admm_k1_resident"),
                CFG4C_SPEC["wave_size"])
    check(all(bool(r.found) for r in single),
          "config 4c feedback: an instance without a plan")
    ref = np.array([float(r.obj) for r in single])
    scale = np.maximum(1.0, np.abs(ref))
    lower = ref - np.array([float(r.gap) for r in single]) * scale
    pooled = objs[list(CFG4C_HELD)]
    rel = np.abs(pooled - ref) / scale
    capped = sum(float(r.gap) > 0 for r in single)
    lim = serve_limit(ref)
    print(f"  single-instance feedback: {ms1:.0f} ms a tree, "
          f"{got1['admm_k2_resident'] + got1['admm_k1_resident']} waves for "
          f"{len(CFG4C_HELD)} trees, {capped} ended with a certified gap "
          f"> 0; pooled lower on {int((pooled < ref).sum())}, worst relative "
          f"|Δobj| {rel.max():.2e} (limit 1e-3); |Δobj| within serve_limit "
          f"on {int((np.abs(pooled - ref) <= lim).sum())} of "
          f"{len(CFG4C_HELD)}, worst {np.abs(pooled - ref).max():.2e} (a "
          f"reading)", flush=True)
    check(rel.max() <= 1e-3, f"config 4c: pooled {rel.max():.3e} off the "
          "single-instance feedback")
    check(bool((pooled >= lower - 1e-3 * scale).all()), "config 4c: a pooled "
          "objective below the single search's certified bound")
    return dict(batch=B, S=CFG4C_S, N=CFG4C_N, wave_path=path,
                seconds=times, tree_miqp_per_s=B / dt, found_frac=found,
                mean_obj=float(objs.mean()), waves=waves,
                probing_waves=probing, nodes=nodes, k1_launches=k1,
                k1_share=k1_s / dt, feedback_ms=ms1)


def phase_tree_hold(dev):
    """Exact holds of the tree paths on the card: tests/test_bnb_pooled.py's
    S=2, N=4 tree (branching at 1) through the pool (rep-map branching,
    its spec) within 1e-3 (relative, floor 1) of the port's fp64 oracle on
    the joint frame (oracle_bnb); the consensus tree on
    tests/test_consensus_tree.py's fixture (S=4, N=6, branching at 1 and
    3, from [2, 0]) against the dense joint build: objective within 2e-3,
    first input within 2e-2, the consensus first stage shared."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.models import di_default_weights
    from pyhybridcontrol_tpu_torch.ops.scenario_tree import ScenarioTree
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    model, w = omega_model(), di_default_weights()
    tree = ScenarioTree.from_branching(
        np.random.default_rng(3).normal(0.0, 0.3, size=(2, 4, 1)),
        branch_steps=(1,))
    ctrl = MpcController(model, 4, w, device=dev)
    ctrl.set_scenario_tree(tree)
    ctrl.bnb_spec = BnbSpec(capacity=512, wave_size=32, qp_iters=600,
                            probe_iters=3000, max_waves=48)
    x0s = np.array([[2.0, 0.0], [-1.5, 1.0]], np.float32)
    t0 = time.perf_counter()
    res = ctrl.feedback_batch(x0s, engine="pooled", pooled_wave=128,
                              pool_slots=1024)
    ms = 1e3 * (time.perf_counter() - t0)
    joint, W = ctrl.condensed, tree.omega_paths.reshape(-1, 1)
    for i, x0 in enumerate(x0s):
        orc, nodes = oracle_bnb(joint, *joint.assemble_np(x0, W))
        rel = abs(float(res.obj[i]) - orc) / max(1.0, abs(orc))
        print(f"  pooled tree S=2 N=4 x0={x0.tolist()}: {float(res.obj[i]):.5f}"
              f", fp64 oracle {orc:.5f} ({nodes} nodes), relative {rel:.2e} "
              f"(limit 1e-3); the call {ms:.0f} ms", flush=True)
        check(bool(res.found[i]) and rel <= 1e-3,
              f"pooled tree instance {i}: {rel:.3e} off the fp64 oracle")

    tree = ScenarioTree.from_branching(
        np.random.default_rng(3).normal(0.0, 0.3, size=(4, 6, 1)),
        branch_steps=(1, 3))
    spec = BnbSpec(capacity=256, wave_size=32, max_waves=48, qp_iters=600,
                   probe_iters=3000)
    out = {}
    for consensus in (False, True):
        ct = MpcController(model, 6, w, bnb_spec=spec, qp_iters=600,
                           device=dev)
        ct.set_scenario_tree(tree, consensus=consensus)
        t0 = time.perf_counter()
        out[consensus] = r = ct.feedback([2.0, 0.0])
        print(f"  {'consensus' if consensus else 'dense joint'} tree S=4 "
              f"N=6 from [2, 0]: objective {float(r.obj):.5f}, u "
              f"{r.u.tolist()}, {int(r.nodes)} nodes, "
              f"{1e3 * (time.perf_counter() - t0):.0f} ms", flush=True)
        check(bool(r.found), "tree hold: no plan found")
    dense, cons = out[False], out[True]
    d_obj = abs(float(cons.obj) - float(dense.obj))
    d_u = float((cons.u - dense.u).abs().max())
    spread = float(np.ptp(cons.v_seq.reshape(4, 6, -1)[:, 0, 0].cpu()
                          .numpy()))
    print(f"  consensus vs dense joint: |Δobj| {d_obj:.2e} (limit "
          f"{2e-3 * (1 + abs(float(dense.obj))):.2e}), |Δu| {d_u:.2e} "
          f"(2e-2), first-stage spread {spread:.2e} (1e-3)", flush=True)
    check(d_obj <= 2e-3 * (1 + abs(float(dense.obj))) and d_u <= 2e-2
          and spread < 1e-3, "consensus tree off the dense joint build")


def recorded(step, log):
    """``step`` (a closed loop's control step) with each call's
    (x, W, price_seq, V) appended to ``log``."""
    def rec(x, W=None, price_seq=None, u_prev=None, prev=None):
        out = step(x, W, price_seq, u_prev, prev=prev)
        log.append((x, W, price_seq, out[4]))
        return out

    for k in ("carries_plan", "n_dec", "device"):
        setattr(rec, k, getattr(step, k))
    return rec


def np_or_none(t):
    return None if t is None else t.double().cpu().numpy()


def launched_at(path, kernels, B):
    """Every launch of ``kernels`` on ``path`` had batch B."""
    got = {k: v for k, v in PATH_BATCHES[path].items() if k in kernels}
    check(all(set(v) == {B} for v in got.values()),
          f"{path}: launches not all at B={B}: {got}")


CFG2_STATES = ([1.5, 0.0], [-1.0, 0.5], [0.8, -1.2])
# the JAX package's objectives of the config-2 and 2b calls and of the
# served states (in CFG2_STATES's order, after the serve loop's warm-up at
# x = 0) on the CPU (tools/config2_reference.py): printed beside the port's,
# a reading and not a gate, since the wave-capped searches may legitimately
# walk other trees
CFG2_REF_OBJ = {"config2_call": 61.35150146484375,
                "config2b_call": 61.004432678222656,
                "config2_serve": (61.4104118347168, 22.4517765045166,
                                  23.083187103271484)}
CFG2_OUT_OF_BOX = [6.0, 0.0]     # the spring's box is |x| ≤ 5


def phase_config2_serve(dev):
    """Config 2 served: ``serve --config pwa_actuator --device cuda``
    through the stdin loop — a ping, three states, one outside the box
    (found=false), quit. Each returned plan is held in fp64 against the
    port's CondensedMpc (G V ≤ h, the box, binaries 0/1: FEAS_TOL) and its
    objective recomputed from V against the reported one (serve_limit);
    resident K2 must launch."""
    from pyhybridcontrol_tpu_torch import serve

    print("serve --config pwa_actuator --device cuda:", flush=True)
    t0 = time.perf_counter()
    ctrl, ready = serve.build_controller("pwa_actuator", "bnb", dev.type)
    print(f"  controller built + warmup solve: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    c = ctrl.condensed
    check(c.nV == c.N * c.info.nv, "config 2: the decision is not the plain "
          "per-step frame")
    sols = []
    feedback = ctrl.feedback     # record each served solve's plan

    def keep(*a, **kw):
        sols.append(feedback(*a, **kw))
        return sols[-1]

    ctrl.feedback = keep
    lines = ['{"cmd": "ping"}']
    lines += [json.dumps({"x": x, "id": i}) for i, x in enumerate(CFG2_STATES)]
    lines += [json.dumps({"x": CFG2_OUT_OF_BOX, "id": "out_of_box"}),
              '{"cmd": "quit"}']
    out = io.StringIO()
    try:
        drive("config2_serve", lambda: serve.stdin_loop(
            ctrl, ready, inp=io.StringIO("\n".join(lines) + "\n"), out=out))
    finally:
        del ctrl.feedback
    launches = PATH_LAUNCHES["config2_serve"]
    replies = [json.loads(s) for s in out.getvalue().splitlines()]
    check(replies[0].get("ready") is True, "config2 serve: no ready line")
    check(replies[1] == {"pong": True}, "config2 serve: ping not answered")
    check(len(replies) == 2 + len(CFG2_STATES) + 1,
          "config2 serve: missing replies")
    check(launches["admm_k2_resident"] > 0,
          f"config2 serve: resident K2 was never launched: {launches}")
    diffs, refs = [], []
    for x, r, sol, jref in zip(CFG2_STATES, replies[2:], sols,
                               CFG2_REF_OBJ["config2_serve"]):
        check("error" not in r and r["found"], f"config2 serve: {x}: {r}")
        V = sol.v_seq.reshape(-1).double().cpu().numpy()
        (obj,) = plans_feasible(f"x0={x}", c, [(V, x, None, None)])
        print(f"  x0={x}: obj={r['obj']:.6f} (fp64 from the plan "
              f"{obj:.6f}; the JAX package on the CPU {jref:.6f}, relative "
              f"{(r['obj'] - jref) / max(1.0, abs(jref)):+.2e}), gap "
              f"{r['gap']:.2e}, ms={r['ms']}", flush=True)
        diffs.append(abs(obj - r["obj"]))
        refs.append(obj)
    serve_reading("config2 serve, fp64 objective of the plan", diffs, refs)
    bad = replies[-1]
    check("error" not in bad and bad["found"] is False,
          f"config2 serve: the out-of-box state must be found=false: {bad}")
    print(f"  x0={CFG2_OUT_OF_BOX}: found=false ms={bad['ms']}", flush=True)


def phase_config2_calls(dev):
    """The reference bench's config-2 call (bench.py:482-495) from [1.5, 0]:
    the repair seed at 400 iterations, the probe at ρ=10, capacity 1024,
    wave 128, 16 waves, 200 + 600 iterations, gap 1e-3, probe_patience=3;
    then config 2b's (bench.py:904-906): rel_gap=0.02, capacity 8192, 128
    waves. ms per solve (after the bench's warm-up), nodes, objective and
    certified relative gap; each plan feasible in fp64."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec, solve_miqp_bnb
    from pyhybridcontrol_tpu_torch.solver.repair import (
        prepare_repair, root_repair_incumbent)

    model, w, c = bench_frame("config2")
    qp = c.device_qp(dev)
    admm = prepare_admm_mpc(c, device=dev)
    admm_p = prepare_admm_mpc(c, rho=10.0, device=dev)
    rspec = prepare_repair(model, w, device=dev)
    x0 = torch.tensor([1.5, 0.0], device=dev)
    base = dict(wave_size=128, qp_iters=200, probe_iters=600, gap=1e-3,
                probe_patience=3)
    specs = (("config2_call", BnbSpec(capacity=1024, max_waves=16, **base)),
             ("config2b_call", BnbSpec(capacity=8192, max_waves=128,
                                       rel_gap=0.02, **base)))

    def fb(spec):
        f, h = qp.assemble(x0)
        seed = root_repair_incumbent(admm, qp, rspec, x0, f, h, qp_iters=400)
        return solve_miqp_bnb(admm, qp, f, h, spec, init_incumbent=seed,
                              admm_probe=admm_p)

    fb(specs[0][1])                                  # warm-up, as the bench's
    out = {}
    for path, spec in specs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r, _ = drive(path, lambda: fb(spec))
        ms = 1e3 * (time.perf_counter() - t0)
        obj, bo = float(r.obj), float(r.best_open_bound)
        gap = ((obj - bo) / max(1.0, abs(obj))
               if np.isfinite(bo) and bo < obj else 0.0)
        got = PATH_LAUNCHES[path]
        jref = CFG2_REF_OBJ[path]
        print(f"  {path}: {ms:.1f} ms per solve, {r.waves} waves, "
              f"{int(r.nodes_solved)} nodes, objective {obj:.4f} (the JAX "
              f"package on the CPU {jref:.4f}, relative "
              f"{(obj - jref) / max(1.0, abs(jref)):+.2e}), certified "
              f"rel. gap {gap:.4f}, overflow {bool(r.overflow)}, resident "
              f"K2 {got['admm_k2_resident']} and K1 (gated waves) "
              f"{got['admm_k1_resident']} launches", flush=True)
        check(bool(r.found), f"{path}: no plan found")
        check(got["admm_k2_resident"] > 0, f"{path}: no resident K2: {got}")
        check(got["admm_k2_resident"] + got["admm_k1_resident"] == r.waves,
              f"{path}: {r.waves} waves, launches {got}")
        launched_at(path, ("admm_k1_resident", "admm_k2_resident"), 128)
        plans_feasible(path, c, [(r.x.double().cpu().numpy(), [1.5, 0.0],
                                  None, None)])
        out[path] = dict(ms_per_solve=ms, waves=r.waves,
                         nodes=int(r.nodes_solved), objective=obj,
                         jax_objective=jref, certified_rel_gap=gap)
    g2, g2b = out["config2_call"], out["config2b_call"]
    if g2b["certified_rel_gap"] <= 0.02:
        print(f"  config 2b ended on a certified gap "
              f"{g2b['certified_rel_gap']:.4f} ≤ 0.02", flush=True)
    else:
        check(g2b["waves"] == 128, "config 2b: gap above 0.02 before the "
              "wave cap")
        print(f"  config 2b: the wave cap (128) ended it at a certified gap "
              f"{g2b['certified_rel_gap']:.4f}", flush=True)
    check(g2b["objective"] <= g2["objective"]
          + float(serve_limit(g2["objective"])),
          "config 2b: a longer search ended on a worse plan")
    return out


# ---- config 2's search options, its cut frame, device condensation -------
# scripts/config2_sb_ab.py's config-2 arm: the PWA spring (hull), N=20, the
# repair seed at 400 iterations, the probe prep at ρ=10, from [1.5, 0], to
# the certified 2% stop
CFG2_SB_SPEC = dict(capacity=2048, wave_size=128, max_waves=64,
                    qp_iters=200, probe_iters=600, gap=1e-3,
                    probe_patience=3, rel_gap=0.02)
CFG2_SB = dict(sb_iters=400)
CFG2_ARMS = {"a": {}, "b": CFG2_SB, "c": dict(CFG2_SB, sb_fix=True),
             "d": dict(CFG2_SB, sb_fix=True, root_iters=3200,
                       dive_slots=16),
             "e": dict(depth_tiebreak=1e-2),
             "f": dict(branching="flipdelta")}
CFG2_X0 = [1.5, 0.0]
# the x0 trust box of config 2's split cuts (tests/test_cuts.py's, around
# CFG2_X0); cut generation takes the defaults (3 rounds of 8, no tilts)
TRUST_BOX = ([0.5, -1.0], [2.5, 1.0])
# the JAX package's readings of the same arms on the CPU (objective, nodes,
# waves, best open bound; tools/config2_sb_reference.py); "cut": arm d on
# the reference's own cut frame. A reading printed beside the port's, not
# a gate: the two may walk other trees
CFG2_ARMS_REF = {
    "a": (61.004432678222656, 5561, 52, 59.82452392578125),
    "b": (61.022605895996094, 6169, 64, 58.65373229980469),
    "c": (61.00474166870117, 7423, 64, 58.65326690673828),
    "d": (61.59383773803711, 7333, 64, 60.299102783203125),
    "e": (60.991615295410156, 6457, 59, 59.79573440551758),
    "f": (61.78522491455078, 7379, 64, 58.05635070800781),
    "cut": (61.95021438598633, 7423, 64, 58.70197677612305),
}


def cfg2_setup(dev, c=None):
    """Config 2's solve on ``dev`` (frame ``c``, else the bench's):
    (frame, DeviceQP, ADMM prep, probe prep at ρ=10, repair spec)."""
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu_torch.solver.repair import prepare_repair

    model, w, c0 = bench_frame("config2")
    c = c0 if c is None else c
    return types.SimpleNamespace(
        c=c, qp=c.device_qp(dev), admm=prepare_admm_mpc(c, device=dev),
        admm_p=prepare_admm_mpc(c, rho=10.0, device=dev),
        rspec=prepare_repair(model, w, device=dev))


def cfg2_solve(st, spec, x0):
    """One config-2 solve as the bench's call: assemble, repair seed, B&B."""
    from pyhybridcontrol_tpu_torch.solver.bnb import solve_miqp_bnb
    from pyhybridcontrol_tpu_torch.solver.repair import root_repair_incumbent

    f, h = st.qp.assemble(x0)
    seed = root_repair_incumbent(st.admm, st.qp, st.rspec, x0, f, h,
                                 qp_iters=400)
    return solve_miqp_bnb(st.admm, st.qp, f, h, spec, init_incumbent=seed,
                          admm_probe=st.admm_p)


@contextlib.contextmanager
def captured(method, log):
    """``CondensedBackend.<method>`` with each call's (backend, args,
    kwargs) appended to ``log`` inside the block."""
    from pyhybridcontrol_tpu_torch.solver.bnb import CondensedBackend

    orig = getattr(CondensedBackend, method)

    def call(self, *a, **kw):
        log.append((self, a, kw))
        return orig(self, *a, **kw)

    setattr(CondensedBackend, method, call)
    try:
        yield log
    finally:
        setattr(CondensedBackend, method, orig)


def sb_batch(st, x0):
    """The candidate batch of root strong branching at x0 as K1 gets it:
    ``_bnb_loop`` with no wave (the root relaxation, then the 2·nb
    children, binary j fixed to 0 and to 1, 400 iterations warm from the
    root), its ``solve_cert`` call captured. Returns (q, h, lb, ub, warm)."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.solver.bnb import (
        BnbSpec, CondensedBackend, _bnb_loop)

    log = []
    f, h = st.qp.assemble(x0)
    with captured("solve_cert", log):
        _bnb_loop(CondensedBackend(st.admm, st.qp, st.admm_p), f, h,
                  BnbSpec(**dict(CFG2_SB_SPEC, **CFG2_ARMS["c"],
                                 max_waves=0)))
    (_, (q, hh, lb, ub, iters), kw), = log
    check(iters == CFG2_SB["sb_iters"], f"sb_batch: {iters} iterations")
    hb, lbb, ubb, warm = ca._batch(q, hh, lb, ub, kw["warm"], st.admm.m_ineq)
    return q, hb, lbb, ubb, warm


def variant(kernel, pl):
    """The launch-count name of ``kernel`` ("admm_k1" or "admm_k2") under
    plan ``pl``."""
    return kernel + ("_streamed" if pl.streamed else "_resident"
                     if pl.cluster > 1 else "")


def phase_md_shapes(dev, rng, recs):
    """K2 at the per-rank waves of the multi-device phase that no other
    phase holds, warm, against its plain version: config 5's pool wave on
    its frame (the PWA spring, big-M, N=14; B=256, 300 + 300 iterations:
    relaxation "md_pool", probe "wave_probe", FLIP_SHARE_HULL, certificate
    bits as the real frames'), and the wave of ``feedback_batch(mesh=)``'s
    slice (128 instances of the N=20 double integrator: the pooled
    engine's global wave of 1024, 300 + 300; "md_slice"); each with its
    plan and, with TIMINGS, its times. LIMITS has the readings the two
    regimes rest on. (K4 at a rank's half of config 6's wave is in phase
    20.)"""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    print("K2 at the ranks' shapes (multi-device phase):", flush=True)
    spec, spec_p, bidx, q, h, lb, ub = real_problem("config5", 256, dev, rng)
    _, qp20, s20, s20p, f20, h20, lb20, ub20 = problem(20, 1024, dev, rng,
                                                       fix_frac=0.3)
    for (tag, key, kq, kq2, bi, qq, hh, lo, hi, B, regime, probe_regime,
         flips) in (
            ("config 5 pool wave", "md_cfg5", ca.kernel_qp_for(spec),
             ca.kernel_qp_for(spec_p), bidx, q, h, lb, ub, 256, "md_pool",
             "wave_probe", FLIP_SHARE_HULL),
            ("feedback_batch slice", "md_fb", ca.kernel_qp_for(s20),
             ca.kernel_qp_for(s20p), qp20.binary_idx, f20, h20, lb20, ub20,
             1024, "md_slice", "md_slice", FLIP_SHARE)):
        pl = ca.plan(B, kq.n_pad, kq.m_pad)
        name = variant("admm_k2", pl)
        wargs = (kq, kq2, bi, qq, hh, lo, hi)
        kw = dict(iters=300, probe_iters=300)
        cold = ca.admm_wave_plain(*wargs, **kw)
        warm = (cold[0].x, cold[0].z, cold[0].y)
        compare_probe(f"K2 {tag} B={B} 300+300 it warm",
                      ca.admm_wave_cuda(*wargs, warm=warm, **kw),
                      ca.admm_wave_plain(*wargs, warm=warm, **kw),
                      types.SimpleNamespace(binary_idx=bi), lo, hi,
                      recs[name], regime, flip_share=flips,
                      probe_regime=probe_regime, plain=(kq, qq, hh, lo, hi))
        recs[name][key + "_plan"] = dict(B=B, pb=pl.pb, cluster=pl.cluster,
                                         threads=pl.threads, smem=pl.smem)
        print(f"  {tag}: {name}, tile {pl.pb}, cluster {pl.cluster}, "
              f"{pl.threads} threads, {pl.smem} B shared", flush=True)
        if not TIMINGS:
            continue
        timed(recs[name], key + "_",
              lambda: ca.admm_wave_cuda(*wargs, warm=warm, **kw),
              lambda: ca.admm_wave_plain(*wargs, warm=warm, **kw),
              admm_work(kq.n_pad, kq.m_pad, B, products=602, stats=2,
                        warm=True, stiff=True, outputs=2))


def phase_sb_batch(dev, rng, recs):
    """K1 at root strong branching's batch: config 2's 2·nb = 120
    candidate children of the root (each one binary fixed), 400 iterations
    warm from the root relaxation, from CFG2_X0 at seed 0 and a state drawn
    in the trust box otherwise; against its plain version on every output
    ("strong_branching" limits) and on the certificate bits exactly:
    ``sb_fix`` fixes binaries from them. Times the shape beside its
    bound."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    x0 = (CFG2_X0 if SEED == 0
          else rng.uniform(*TRUST_BOX).astype(np.float32).tolist())
    print(f"K1 at the strong-branching batch (config 2, x0={x0}):",
          flush=True)
    st = cfg2_setup(dev)
    q, h, lb, ub, warm = sb_batch(st, torch.tensor(x0, device=dev))
    B, iters = q.shape[0], CFG2_SB["sb_iters"]
    kq = ca.kernel_qp_for(st.admm)
    pl = ca.plan(B, kq.n_pad, kq.m_pad)
    rec = recs[variant("admm_k1", pl)]
    args = (kq, q, h, lb, ub)
    got = ca.admm_solve_cuda(*args, iters=iters, warm=warm)
    ref = ca.admm_solve_plain(*args, iters=iters, warm=warm)
    compare(f"K1 strong-branching batch B={B} {iters} it warm", got, ref,
            rec, "strong_branching")
    rec["config2_sb_plan"] = dict(B=B, pb=pl.pb, cluster=pl.cluster,
                                  threads=pl.threads, smem=pl.smem)
    print(f"  plan B={B}: {variant('admm_k1', pl)}, tile {pl.pb}, cluster "
          f"{pl.cluster}", flush=True)
    if TIMINGS:
        timed(rec, f"config2_sb_B{B}_",
              lambda: ca.admm_solve_cuda(*args, iters=iters, warm=warm),
              lambda: ca.admm_solve_plain(*args, iters=iters, warm=warm),
              admm_work(kq.n_pad, kq.m_pad, B, products=iters + 1, stats=1,
                        warm=True))


def hold_wave(tag, call, recs, pre):
    """K2 on one wave the path gave it (``captured("solve_wave")``'s
    entry) against its plain version: the relaxation on "main", the probe
    on "wave_probe", FLIP_SHARE_HULL (config 2's hull binaries at 0.5),
    certificate bits as phase 9's; and its times under keys ``pre``.
    Returns the record's name."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    be, (f, h, lb, ub, iters, piters), kw = call
    kq, kq2 = ca.kernel_qp_for(be.admm), ca.kernel_qp_for(be.admm_probe)
    hb, lbb, ubb, warm = ca._batch(f, h, lb, ub, kw.get("warm"),
                                   be.admm.m_ineq)
    B = f.shape[0]
    pl = ca.plan(B, kq.n_pad, kq.m_pad)
    name = variant("admm_k2", pl)
    wargs = (kq, kq2, be.binary_idx, f, hb, lbb, ubb)
    kwi = dict(iters=iters, probe_iters=piters, warm=warm)
    compare_probe(f"K2 {tag} B={B} {iters}+{piters} it warm",
                  ca.admm_wave_cuda(*wargs, **kwi),
                  ca.admm_wave_plain(*wargs, **kwi),
                  types.SimpleNamespace(binary_idx=be.binary_idx), lbb, ubb,
                  recs[name], "main", flip_share=FLIP_SHARE_HULL,
                  probe_regime="wave_probe", plain=(kq, f, hb, lbb, ubb))
    recs[name][pre + "plan"] = dict(B=B, pb=pl.pb, cluster=pl.cluster,
                                    threads=pl.threads, smem=pl.smem,
                                    n_pad=kq.n_pad, m_pad=kq.m_pad)
    timed(recs[name], pre, lambda: ca.admm_wave_cuda(*wargs, **kwi),
          lambda: ca.admm_wave_plain(*wargs, **kwi),
          admm_work(kq.n_pad, kq.m_pad, B, products=iters + piters + 2,
                    stats=2, warm=True, stiff=True, outputs=2))
    return name


def arm_reading(path, kw, r, ms, c, sb_batch_size):
    """Print and check one arm's solve: found, its plan feasible in fp64,
    the waves = K2 + gated K1 launches (at the wave), root strong
    branching's one K1 launch at its batch and the root solves at B=1
    apart. Returns the reading."""
    import numpy as np

    got = PATH_LAUNCHES[path]
    k1 = PATH_BATCHES[path].get("admm_k1_resident", {})
    W = CFG2_SB_SPEC["wave_size"]
    gated, sbl, roots = k1.get(W, 0), k1.get(sb_batch_size, 0), k1.get(1, 0)
    sb = kw.get("sb_iters", 0) > 0
    want_roots = int(sb) + int(kw.get("root_iters", 0)
                               > CFG2_SB_SPEC["qp_iters"])
    obj, bo = float(r.obj), float(r.best_open_bound)
    gap = ((obj - bo) / max(1.0, abs(obj))
           if np.isfinite(bo) and bo < obj else 0.0)
    ref = CFG2_ARMS_REF.get(path.rsplit("_", 1)[-1])
    print(f"  {path} {kw}: {ms:.1f} ms, {r.waves} waves, "
          f"{int(r.nodes_solved)} nodes, objective {obj:.4f}, certified "
          f"rel. gap {gap:.4f}, best open bound {bo:.4f}; resident K2 "
          f"{got['admm_k2_resident']} (B={W}), resident K1 {gated} gated "
          f"(B={W}) + {sbl} strong-branching (B={sb_batch_size}) + {roots} "
          f"root (B=1)" + (f"; the JAX package on the CPU: objective "
                           f"{ref[0]:.4f}, {ref[1]} nodes, {ref[2]} waves, "
                           f"best open bound {ref[3]:.4f}" if ref else ""),
          flush=True)
    check(bool(r.found), f"{path}: no plan found")
    others = {k: v for k, v in got.items() if v and k not in
              ("admm_k1_resident", "admm_k2_resident")}
    check(not others, f"{path}: other kernels launched: {others}")
    check(set(k1) <= {W, sb_batch_size, 1}, f"{path}: K1 batches {k1}")
    check(got["admm_k2_resident"] + gated == r.waves,
          f"{path}: {r.waves} waves, launches {got}, K1 batches {k1}")
    check(sbl == int(sb), f"{path}: {sbl} strong-branching launches")
    check(roots == want_roots, f"{path}: {roots} root solves, want "
          f"{want_roots}")
    launched_at(path, ("admm_k2_resident",), W)
    (fobj,) = plans_feasible(path, c, [(r.x.double().cpu().numpy(), CFG2_X0,
                                        None, None)])
    return dict(ms_per_solve=ms, waves=r.waves, nodes=int(r.nodes_solved),
                objective=obj, objective_fp64=fobj, best_open_bound=bo,
                certified_rel_gap=gap, k2=got["admm_k2_resident"],
                k1_gated=gated, k1_strong_branching=sbl, k1_root=roots)


def certified_low(o):
    """A certified lower bound on the MIQP's optimum from one arm: the best
    open bound, or the incumbent less the pruning gap where the search
    closed every node below it."""
    return min(o["best_open_bound"], o["objective"] - CFG2_SB_SPEC["gap"])


def phase_config2_arms(dev, recs):
    """Config 2's search arms (scripts/config2_sb_ab.py's config-2 arm):
    (a) none, (b) sb_iters=400, (c) (b) + sb_fix, (d) root_iters=3200 + (c)
    + dive_slots=16, (e) depth_tiebreak=1e-2, (f) branching="flipdelta";
    each driven once after one warm-up solve of (d), as its own path. Each
    plan feasible in fp64; every arm solves the same MIQP, so the largest
    certified lower bound of an arm lies at most serve_limit above the
    smallest objective. K2 is held on the last wave of the warm-up's dive
    lane (its deepest nodes)."""
    import torch

    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    st = cfg2_setup(dev)
    x0 = torch.tensor(CFG2_X0, device=dev)
    B_sb = 2 * st.qp.n_binary
    waves = []
    with captured("solve_wave", waves):
        cfg2_solve(st, BnbSpec(**CFG2_SB_SPEC, **CFG2_ARMS["d"]), x0)
    out = {}
    for arm, kw in CFG2_ARMS.items():
        spec = BnbSpec(**CFG2_SB_SPEC, **kw)
        path = f"config2_sb_{arm}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r, _ = drive(path, lambda: cfg2_solve(st, spec, x0))
        out[arm] = arm_reading(path, kw, r, 1e3 * (time.perf_counter() - t0),
                               st.c, B_sb)
    low = max(certified_low(o) for o in out.values())
    best = min(o["objective"] for o in out.values())
    print(f"  across the arms: largest certified lower bound {low:.4f}, "
          f"smallest objective {best:.4f}", flush=True)
    check(low <= best + float(serve_limit(best)),
          f"config 2 arms: a certified lower bound {low:.4f} above an "
          f"objective {best:.4f}")
    hold_wave("config 2 arm d, last dive-lane wave", waves[-1], recs,
              "config2_dive_wave_")
    return out


def phase_config2_cut(dev, recs, arms):
    """Config 2's split cuts (ops/cuts.py, the defaults, TRUST_BOX around
    CFG2_X0), generated on the host in fp64, then arm (d) on the cut
    frame: its plan feasible in fp64 on the cut frame and on the original
    one, its objective no lower than the uncut arms' largest certified
    lower bound less serve_limit, the K2 variant its plan picked held and
    timed on its last wave; an x0 outside the box refused on the host and
    on the card."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.ops.cuts import with_split_cuts
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    _, _, c = bench_frame("config2")
    t0 = time.perf_counter()
    cut, d = with_split_cuts(c, *TRUST_BOX, CFG2_X0,
                             return_diagnostics=True)
    gen_s = time.perf_counter() - t0
    print(f"  split cuts: {d.n_cuts} in {d.rounds} rounds, {gen_s:.2f} s on "
          f"the host; root bound {d.root_bound_before:.4f} → "
          f"{d.root_bound_after:.4f}; frame {cut.nV}/{cut.G.shape[0]}"
          + (f" ({d.notes})" if d.notes else ""), flush=True)
    check(d.n_cuts > 0, "config 2: no split cut generated")
    st = cfg2_setup(dev, cut)
    kq = ca.kernel_qp_for(st.admm)
    W = CFG2_SB_SPEC["wave_size"]
    x0 = torch.tensor(CFG2_X0, device=dev)
    spec = BnbSpec(**CFG2_SB_SPEC, **CFG2_ARMS["d"])
    cfg2_solve(st, spec, x0)                          # warm-up
    waves = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with captured("solve_wave", waves):
        r, _ = drive("config2_cut", lambda: cfg2_solve(st, spec, x0))
    ms = 1e3 * (time.perf_counter() - t0)
    obj, bo = float(r.obj), float(r.best_open_bound)
    got = PATH_LAUNCHES["config2_cut"]
    ref = CFG2_ARMS_REF.get("cut")
    print(f"  arm d on the cut frame: {ms:.1f} ms, {r.waves} waves, "
          f"{int(r.nodes_solved)} nodes, objective {obj:.4f}, best open "
          f"bound {bo:.4f}; launches {({k: v for k, v in got.items() if v})}"
          + (f"; the JAX package on the CPU: objective {ref[0]:.4f}, "
             f"{ref[1]} nodes, {ref[2]} waves, best open bound {ref[3]:.4f}"
             if ref else ""), flush=True)
    check(bool(r.found), "config 2 cut frame: no plan found")
    k2n = sum(v for k, v in got.items() if k.startswith("admm_k2"))
    k1w = sum(v.get(W, 0) for k, v in PATH_BATCHES["config2_cut"].items()
              if k.startswith("admm_k1"))
    check(k2n + k1w == r.waves, f"config 2 cut frame: {r.waves} waves, "
          f"launches {PATH_BATCHES['config2_cut']}")
    V = r.x.double().cpu().numpy()
    (fcut,) = plans_feasible("config2_cut on the cut frame", cut,
                             [(V, CFG2_X0, None, None)])
    (forig,) = plans_feasible("config2_cut on the original frame", c,
                              [(V, CFG2_X0, None, None)])
    low = max(certified_low(o) for o in arms.values())
    check(forig >= low - float(serve_limit(low)),
          f"config 2 cut frame: objective {forig:.4f} below the uncut "
          f"arms' certified lower bound {low:.4f}")
    k2 = hold_wave("config 2 cut frame, last wave", waves[-1], recs,
                   "config2_cut_wave_")
    check(got[k2] > 0, f"config 2 cut frame: {k2} never launched: {got}")
    print(f"  the cut frame's waves: {k2} (padded {kq.n_pad}/{kq.m_pad}), "
          f"{got[k2]} launches at B={W}", flush=True)
    outside = [TRUST_BOX[1][0] + 0.5, 0.0]
    for what, fn in (("assemble_np", lambda: cut.assemble_np(outside)),
                     ("DeviceQP.assemble", lambda: st.qp.assemble(
                         torch.tensor(outside, device=dev)))):
        try:
            fn()
        except ValueError as e:
            check("trust box" in str(e), f"{what}: {e}")
        else:
            check(False, f"{what}: x0={outside} outside the trust box taken")
    print(f"  x0={outside} outside the trust box: refused on the host and "
          f"on the card", flush=True)
    return dict(cuts=d.n_cuts, rounds=d.rounds, gen_s=gen_s,
                root_bound_before=d.root_bound_before,
                root_bound_after=d.root_bound_after, ms_per_solve=ms,
                waves=r.waves, nodes=int(r.nodes_solved), objective=obj,
                objective_fp64=fcut, best_open_bound=bo, k2_variant=k2,
                k2_launches=got[k2])


CONDENSE_NAMES = ("Phi", "Gv", "Gw", "Gc", "Phi_t", "Gv_t", "Gw_t", "Gc_t")
CONDENSE_VARIANTS = 64      # DEWH parameter variants condensed in one call
CFG6_N = 120


def max_rel(got, ref):
    """max |got − ref| / max |ref| (the absolute error where ref is 0)."""
    import numpy as np

    got = got.double().cpu().numpy()
    ref = np.asarray(ref, np.float64)
    if got.size == 0:
        return 0.0
    scale = float(np.abs(ref).max())
    return float(np.abs(got - ref).max() / (scale if scale > 0 else 1.0))


def held_rel(tag, regime, errs):
    """Errors relative to max |ref| within the regime's limits."""
    limits, seen = LIMITS[regime], READINGS.setdefault(regime, {})
    for k, v in errs.items():
        seen[k] = max(seen.get(k, 0.0), v)
    print(f"  {tag}: " + " ".join(f"{k}={v:.2e}" for k, v in errs.items()),
          flush=True)
    for k, v in errs.items():
        what = f"{tag}: {k} off by {v:.3e}, limit {limits[k]:.1e}"
        if v > limits[k] and READINGS_ONLY:
            OVER.append(what)
        else:
            check(v <= limits[k], what)


def phase_condense(dev, rng):
    """Device condensation (ops/condense_scan.py) on the card against the
    host fp64 build (``CondensedMpc.pred``): config 6's model (the double
    integrator with a velocity disturbance) at N=120; config 3's DEWH at
    N=24 over CONDENSE_VARIANTS parameter variants (C_w, UA, P_h, T_amb
    each scaled by U(0.8, 1.2)) in one batched call; and
    ``affine_scan_rollout`` at N=120 against an fp64 simulation. Errors
    relative to max |ref| ("condense" limits); times of the device build
    and of the host one."""
    import dataclasses

    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.mld.model import MldModel
    from pyhybridcontrol_tpu_torch.models import (
        DewhParams, dewh_model, dewh_weights, di_default_weights)
    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
    from pyhybridcontrol_tpu_torch.ops.condense_scan import (
        affine_scan_rollout, condense_device)
    from pyhybridcontrol_tpu_torch.utils.structdict import StructDict

    out = {}
    model = omega_model()
    t0 = time.perf_counter()
    host = CondensedMpc(model, CFG6_N, di_default_weights()).pred
    host_s = time.perf_counter() - t0
    dm = model.to(dev)
    got = condense_device(dm, CFG6_N)
    held_rel(f"condense_device config 6 N={CFG6_N}", "condense",
             {k: max_rel(got[k], host[k]) for k in CONDENSE_NAMES})
    out["config6"] = dict(ms=cuda_ms(lambda: condense_device(dm, CFG6_N)),
                          host_build_s=host_s)
    base = DewhParams()
    params = [dataclasses.replace(base, **{
        k: getattr(base, k) * float(rng.uniform(0.8, 1.2))
        for k in ("C_w", "UA", "P_h", "T_amb")})
        for _ in range(CONDENSE_VARIANTS)]
    models = [dewh_model(p) for p in params]
    stacked = MldModel(mats=StructDict({
        k: torch.stack([m.mats[k] for m in models]).to(dev)
        for k in models[0].mats}), info=models[0].info)
    t0 = time.perf_counter()
    hosts = [CondensedMpc(m, DEWH_N, dewh_weights()).pred for m in models]
    host_s = time.perf_counter() - t0
    got = condense_device(stacked, DEWH_N)
    held_rel(f"condense_device config 3's DEWH N={DEWH_N}, "
             f"{CONDENSE_VARIANTS} variants", "condense",
             {k: max(max_rel(got[k][i], hosts[i][k])
                     for i in range(CONDENSE_VARIANTS))
              for k in CONDENSE_NAMES})
    out["config3_variants"] = dict(
        ms=cuda_ms(lambda: condense_device(stacked, DEWH_N)),
        host_build_s=host_s)
    m = model.numpy_mats()
    nv = model.info.nv
    v = rng.uniform(-1.0, 1.0, (CFG6_N, nv)).astype(np.float32)
    w = rng.normal(0.0, 0.2, (CFG6_N, 1)).astype(np.float32)
    x0 = np.array([2.0, 0.0], np.float32)
    Bv = np.hstack([m.B1, m.B2, m.B3])
    x, ref = x0.astype(np.float64), []
    for k in range(CFG6_N):
        x = m.A @ x + Bv @ v[k] + m.B4 @ w[k] + m.b5[:, 0]
        ref.append(x)
    args = on_card(dev, x0, v, w)
    held_rel(f"affine_scan_rollout config 6 N={CFG6_N}", "condense",
             {"xs": max_rel(affine_scan_rollout(dm, *args), np.array(ref))})
    out["rollout_ms"] = cuda_ms(lambda: affine_scan_rollout(dm, *args))
    print(f"  condense_device: config 6 N={CFG6_N} "
          f"{out['config6']['ms']:.3f} ms (host fp64 build "
          f"{out['config6']['host_build_s']:.2f} s); DEWH N={DEWH_N} × "
          f"{CONDENSE_VARIANTS} {out['config3_variants']['ms']:.3f} ms (host "
          f"{out['config3_variants']['host_build_s']:.2f} s); "
          f"affine_scan_rollout {out['rollout_ms']:.3f} ms", flush=True)
    return out


def leaf_oracle(c, f, h, bits):
    """fp64 oracle objective of the leaf of ``c`` whose binaries are
    ``bits`` (the reduced QP in the free variables, as the enumeration
    oracle solves it); inf where the leaf is infeasible."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.solver.oracle import solve_qp_oracle

    b = c.binary_idx
    fr = np.setdiff1d(np.arange(c.nV), b)
    r = solve_qp_oracle(c.H[np.ix_(fr, fr)], f[fr] + c.H[np.ix_(fr, b)] @ bits,
                        c.G[:, fr], h - c.G[:, b] @ bits, c.lb[fr], c.ub[fr])
    if r.status != "optimal":
        return np.inf
    return r.obj + 0.5 * bits @ c.H[np.ix_(b, b)] @ bits + f[b] @ bits


def lp_feasible(G, h, lb, ub):
    """Whether G x ≤ h, lb ≤ x ≤ ub has a point (HiGHS, fp64)."""
    import numpy as np
    from scipy.optimize import linprog

    bounds = [(lo if lo > -1e29 else None, hi if hi < 1e29 else None)
              for lo, hi in zip(lb, ub)]
    return linprog(np.zeros(len(lb)), A_ub=G, b_ub=h, bounds=bounds,
                   method="highs").status != 2


def oracle_bnb(c, f, h):
    """(fp64 optimum, nodes) of frame ``c``'s MIQP at (f, h): depth-first
    branch and bound on the port's fp64 QP oracle. The oracle itself picks
    the leaves it solves (leaf_oracle): a node is pruned when HiGHS finds
    its box empty or its exact relaxation bound reaches the incumbent, and
    branches on its most fractional binary. Exact as enumerating all 2^nb
    leaves is (tests/test_torch_kernels.py holds it to
    solve_miqp_enumeration_oracle), at a few dozen nodes."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.solver.oracle import solve_qp_oracle

    b = np.asarray(c.binary_idx)
    best, nodes, stack = np.inf, 0, [(c.lb.copy(), c.ub.copy())]
    while stack:
        lb, ub = stack.pop()
        nodes += 1
        if not lp_feasible(c.G, h, lb, ub):
            continue
        r = solve_qp_oracle(c.H, f, c.G, h, lb, ub)
        free = ub[b] > lb[b]
        if r.status == "optimal":
            if r.obj >= best - 1e-9 * max(1.0, abs(best)):
                continue
            frac = np.abs(r.x[b] - np.round(r.x[b]))
            if frac.max() <= 1e-6 or not free.any():
                best = min(best, leaf_oracle(c, f, h, np.round(r.x[b])))
                continue
        elif not free.any():     # no bound: solve the leaf itself
            best = min(best, leaf_oracle(c, f, h, lb[b]))
            continue
        else:                    # no bound: branch on a free binary
            frac = free.astype(float)
        j = b[int(np.argmax(np.where(free, frac, -1.0)))]
        near = round(float(r.x[j])) if r.status == "optimal" else 0
        for v in (1 - near, near):      # the nearer child first
            lo, hi = lb.copy(), ub.copy()
            lo[j] = hi[j] = v
            stack.append((lo, hi))
    return best, nodes


HOLD_STATES = 5
# enumeration's ADMM iterations: the hull frame's leaves (per-region copies
# and aggregation rows) converge slower, so config 2 takes the 1500 of the
# reference's own PWA enumeration test (tests/test_mld.py)
HOLD_ITERS = {"config2": 1500, "config3": 600}


def phase_exact_hold(dev):
    """Where enumeration reaches (≤ 15 binaries): config 2's hull frame at
    N=4 (12 binaries) and config 3's frame at N=6 (extra rows, blocking,
    soft rows: 15 binaries), five seeded states each. Through the
    controller on the card, B&B (the config's spec) within serve_limit of
    the port's enumeration (HOLD_ITERS iterations); the enumeration within
    1e-3 (relative, floor 1) of the port's fp64 oracle on the host, which
    finds the optimum on its own (oracle_bnb)."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.configs import get_config
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.models import min_up_down_rows

    for name, N, cfg in (("config2", 4, "pwa_actuator"),
                         ("config3", 6, "thermal_uc")):
        model, w, c = bench_frame(name, N)
        nb = len(c.binary_idx)
        check(nb <= 15, f"{name} N={N}: {nb} binaries")
        spec = get_config(cfg).bnb
        ctrls = [MpcController(model, N, w, solver=s, bnb_spec=spec,
                               qp_iters=q, device=dev)
                 for s, q in (("bnb", spec.qp_iters),
                              ("enumerate", HOLD_ITERS[name]))]
        for ct in ctrls:
            if name == "config3":
                ct.set_extra_constraints(*min_up_down_rows(N, 2, min_up=2))
                ct.set_move_blocking([k // 2 for k in range(N)])
                ct.set_soft_constraints(dewh_soft_rows(N), 5.0, 1.0)
            check(np.array_equal(ct.condensed.G, c.G), f"{name}: the "
                  "controller's frame is not the bench's")
        rng = phase_rng(f"exact_hold_{name}")
        x0s, W, P = bench_data(name, N, HOLD_STATES, rng)
        d_bnb, d_orc, refs = [], [], []
        for i in range(HOLD_STATES):
            Wi = None if W is None else W[i]
            rb, re = (ct.feedback(x0s[i], Wi, P) for ct in ctrls)
            check(bool(rb.found) and bool(re.found), f"{name} state {i}: "
                  f"found B&B {bool(rb.found)}, enumeration "
                  f"{bool(re.found)}")
            d_bnb.append(abs(float(rb.obj) - float(re.obj)))
            refs.append(float(re.obj))
            orc, nodes = oracle_bnb(c, *c.assemble_np(x0s[i], Wi,
                                                      price_seq=P))
            d_orc.append(abs(float(re.obj) - orc) / max(1.0, abs(orc)))
            print(f"  {name} N={N} ({nb} binaries) x0={x0s[i].tolist()}: B&B "
                  f"{float(rb.obj):.5f} ({int(rb.nodes)} nodes), enumeration "
                  f"{float(re.obj):.5f}, fp64 oracle {orc:.5f} ({nodes} "
                  f"nodes)", flush=True)
        serve_reading(f"{name} N={N}: B&B vs enumeration", d_bnb, refs)
        worst = max(d_orc)
        print(f"  {name} N={N}: enumeration vs fp64 oracle, worst relative "
              f"{worst:.2e} (limit 1e-3)", flush=True)
        check(worst <= 1e-3, f"{name}: enumeration {worst:.3e} off the "
              "fp64 oracle")


def golden_replay(tag, res, name, T=None):
    """Total cost of a loop run on the card against a committed golden of
    the reference (rtol 2e-3, tests/test_goldens.py's); the state error is
    printed as a reading."""
    import numpy as np

    g = np.load(ROOT / "tests" / "golden" / name)
    cost, want = float(res.objs.sum()), float(g["total_cost"])
    dx = float(np.abs(res.xs.cpu().numpy() - g["xs"]).max())
    print(f"  {tag} replayed: total cost {cost:.4f}, golden {want:.4f} (rel "
          f"{abs(cost - want) / abs(want):.2e}, limit 2e-3); max |Δx| "
          f"{dx:.2e} (a reading)", flush=True)
    check(bool(res.found.all()), f"{tag} replay: a step without a plan")
    check(abs(cost - want) <= 2e-3 * abs(want) + 2e-3,
          f"{tag} replay: total cost {cost} vs golden {want}")


CFG3_T = 12


def phase_config3_loop(dev):
    """Config 3 of the reference bench as a closed loop (bench.py:515-551):
    N=24, T=12 from [55, 0], seeded draws, flat 0.15 prices, capacity 512,
    wave 64, 32 waves, 200 iterations, probe at ρ=10. Found share 1.0,
    every step's plan feasible in fp64, ms per control step; then the
    golden thermal_uc_N12_T8 replayed on the card."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.loop import closed_loop, make_mpc_step
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    print(f"closed loop, config 3 (N={DEWH_N}, T={CFG3_T}):", flush=True)
    model, w, c = bench_frame("config3")
    qp = c.device_qp(dev)
    step = make_mpc_step(model, qp, prepare_admm_mpc(c, device=dev),
                         method="bnb",
                         bnb_spec=BnbSpec(capacity=512, wave_size=64,
                                          max_waves=32, qp_iters=200,
                                          gap=1e-3),
                         admm_probe=prepare_admm_mpc(c, rho=10.0,
                                                     device=dev))
    rng = phase_rng("config3_loop")
    _, draws, prices = bench_data("config3", DEWH_N, 1, rng, T=CFG3_T)
    log = []
    run = recorded(step, log)
    x0 = [55.0, 0.0]
    closed_loop(model, run, x0, 1, omega_traj=draws[0][:DEWH_N + 1],
                price_traj=prices[:DEWH_N + 1])           # warm-up
    log.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, _ = drive("config3_loop", lambda: closed_loop(
        model, run, x0, CFG3_T, omega_traj=draws[0], price_traj=prices))
    ms = 1e3 * (time.perf_counter() - t0) / CFG3_T
    got = PATH_LAUNCHES["config3_loop"]
    check(got["admm_k2_resident"] > 0 and got["admm_k2"] == 0,
          f"config 3 loop: K2 must run resident, launches {got}")
    launched_at("config3_loop", ("admm_k2_resident",), 64)
    found = float(res.found.float().mean())
    print(f"  {ms:.2f} ms per control step, found share {found:.3f}, nodes "
          f"{res.nodes.tolist()}, T "
          f"{[round(v, 2) for v in res.xs[:, 0].tolist()]}", flush=True)
    check(found == 1.0, "config 3 loop: a step without a plan")
    plans_feasible("config 3 loop", c, [
        (V.double().cpu().numpy(), x.double().cpu().numpy(), np_or_none(W),
         np_or_none(P)) for x, W, P, V in log])
    out = dict(ms_per_control_step=ms, found_frac=found,
               nodes=res.nodes.tolist(), total_cost=float(res.objs.sum()))

    # the committed golden: N=12, T=8, draws of default_rng(7)
    model, w, c12 = bench_frame("config3", 12)
    step = make_mpc_step(model, c12.device_qp(dev),
                         prepare_admm_mpc(c12, device=dev), method="bnb",
                         bnb_spec=BnbSpec(capacity=256, wave_size=32,
                                          qp_iters=300, max_waves=24,
                                          gap=1e-3))
    g_rng = np.random.default_rng(7)
    g_draws = (0.5 * (g_rng.uniform(0, 1, (20, 1)) < 0.25)).astype(np.float32)
    res = closed_loop(model, step, x0, 8, omega_traj=g_draws,
                      price_traj=prices[:20])
    golden_replay("config 3 golden (N=12, T=8)", res, "thermal_uc_N12_T8.npz")
    return out


CFG4B_B, CFG4B_T = 1024, 8
CFG4B_SAMPLE = tuple(range(0, CFG4B_B, 16))    # 64 plans held in fp64


def phase_config4b_loop(dev):
    """Config 4b of the reference bench (bench.py:596-653): 1024 DEWH
    instances in a pooled closed loop, T=8, N=24, pool 8·B, wave 1024,
    capacity 1024, 1024 waves at most, 150 iterations, probe_patience=3,
    the probe at ρ=10. Found share 1.0, every K2 (and K1) launch at
    B=1024, the first-step plans of 64 instances feasible in fp64; control
    steps/s, MIQP/s, nodes. Then the golden dewh_loop_B8_N12_T4 replayed."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.loop import (
        closed_loop_batch, make_mpc_step_batch)
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    B, T = CFG4B_B, CFG4B_T
    print(f"pooled closed loop, config 4b (B={B}, N={DEWH_N}, T={T}):",
          flush=True)

    def step_of(c, B, spec):
        return make_mpc_step_batch(
            model, c.device_qp(dev), prepare_admm_mpc(c, device=dev),
            bnb_spec=spec, pool_slots=8 * B,
            admm_probe=prepare_admm_mpc(c, rho=10.0, device=dev))

    model, w, c = bench_frame("config4b")
    log = []
    step = recorded(step_of(c, B, BnbSpec(capacity=1024, wave_size=1024,
                                          max_waves=1024, qp_iters=150,
                                          probe_patience=3)), log)
    rng = phase_rng("config4b_loop")
    _, draws, prices = bench_data("config4b", DEWH_N, B, rng, T=T)
    x0s = np.tile(np.array([55.0, 0.0], np.float32), (B, 1))
    x0s[:, 0] += rng.uniform(-3, 3, B).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, _ = drive("config4b_loop", lambda: closed_loop_batch(
        model, step, x0s, T, omega_trajs=draws, price_traj=prices))
    dt = time.perf_counter() - t0
    got = PATH_LAUNCHES["config4b_loop"]
    check(got["admm_k2_resident"] > 0 and got["admm_k2"] == 0,
          f"config 4b loop: K2 must run resident, launches {got}")
    launched_at("config4b_loop", ("admm_k2_resident", "admm_k1_resident"), B)
    found = float(res.found.float().mean())
    nodes = int(res.nodes.sum())
    print(f"  {dt:.2f} s: {T / dt:.3f} control steps/s, {B * T / dt:.1f} "
          f"MIQP/s, {nodes} nodes ({nodes / dt:.0f} nodes/s), found share "
          f"{found:.4f}, resident K2 {got['admm_k2_resident']} and K1 (gated "
          f"waves) {got['admm_k1_resident']} launches", flush=True)
    check(found == 1.0, "config 4b loop: an instance-step without a plan")
    x, _, P, V = log[0]
    plans_feasible("config 4b loop, first step", c, [
        (V[i].double().cpu().numpy(), x0s[i], draws[i, :DEWH_N],
         prices[:DEWH_N]) for i in CFG4B_SAMPLE])
    out = dict(seconds=dt, control_steps_per_s=T / dt, miqp_per_s=B * T / dt,
               nodes=nodes, found_frac=found)

    # the committed golden: B=8, N=12, T=4, draws and states of
    # default_rng(11), pool 32·B
    _, _, c12 = bench_frame("config4b", 12)
    g = np.random.default_rng(11)
    g_draws = (0.5 * (g.uniform(0, 1, (8, 16, 1)) < 0.25)).astype(np.float32)
    g_x0s = np.tile(np.array([55.0, 0.0], np.float32), (8, 1))
    g_x0s[:, 0] += g.uniform(-3, 3, 8).astype(np.float32)
    gstep = make_mpc_step_batch(
        model, c12.device_qp(dev), prepare_admm_mpc(c12, device=dev),
        bnb_spec=BnbSpec(capacity=256, wave_size=64, max_waves=256,
                         qp_iters=150, probe_patience=3), pool_slots=32 * 8,
        admm_probe=prepare_admm_mpc(c12, rho=10.0, device=dev))
    res = closed_loop_batch(model, gstep, g_x0s, 4, omega_trajs=g_draws,
                            price_traj=prices[:16])
    golden_replay("DEWH pooled loop golden (B=8, N=12, T=4)", res,
                  "dewh_loop_B8_N12_T4.npz")
    return out


# ---- the stagewise frame: K4 and bench config 6 (phases 20-21) -----------

CFG6_N, CFG6_S, CFG6_STEPS = 120, 8, (1, 40, 80)
CFG6_BUDGET = 60.0          # Σ_k u_k ≤ 60 on every scenario path
CFG6_SPEC = dict(capacity=64, wave_size=8, max_waves=6, qp_iters=150,
                 probe_iters=1000, gap=1e-3)
CFG6_PARITY_SPEC = dict(capacity=512, wave_size=32, qp_iters=600,
                        probe_iters=3000, max_waves=48)
# the JAX package's objective of the long arm (tools/config6_reference.py,
# on the CPU): the port is held within 1e-3 relative of it
CFG6_REF_OBJ = 6.9574198722839355
# the same with parallel_sweeps=True (the log-depth sweeps;
# JAX_PLATFORMS=cpu python tools/config6_reference.py --parallel)
CFG6_REF_OBJ_PAR = 6.957419395446777
CFG6_REPS = 3
X0_6 = (2.0, 0.0)
SERVE_SW_STATES = STATES[:3]
TIMINGS = True       # off: phases 20 and 22 hold only (tools/mutation_check.py)
# the nodes of phase 20's whole-solve hold: a wave of 8 at config 6's
# frame, 30% of the information-set representatives fixed at random
K4_HOLD_FIX = 0.3


def config6_trees():
    """(parity tree, long tree) of config 6: S=2, N=4 branching at 1 from
    default_rng(11), then S=8, N=120 branching at 1, 40, 80 on
    tree-consistent paths of the same generator (bench.py:744-781)."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.ops.scenario_tree import (
        ScenarioTree, tree_consistent_paths)

    rng = np.random.default_rng(11)
    tree_s = ScenarioTree.from_branching(
        rng.normal(0.0, 0.3, size=(2, 4, 1)), branch_steps=(1,))
    tree_l = ScenarioTree.from_branching(
        tree_consistent_paths(rng, CFG6_S, CFG6_N, CFG6_STEPS, sd=0.2),
        branch_steps=CFG6_STEPS)
    return tree_s, tree_l


def config6_extra(N):
    """The long arm's horizon-coupled row: Σ_k u_k ≤ 60."""
    import numpy as np

    A_v = np.zeros((1, N * 3))
    A_v[0, 0::3] = 1.0
    return (A_v, np.array([CFG6_BUDGET]), None, None)


def config6_preps(dev, tree, extra=None):
    """The stagewise tree preps at ρ and ρ·10 (the probes') of config 6."""
    from pyhybridcontrol_tpu_torch.models import di_default_weights
    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        prepare_stagewise_tree)

    kw = {} if extra is None else dict(extra=extra)
    return tuple(prepare_stagewise_tree(omega_model(), tree,
                                        di_default_weights(), rho=r,
                                        device=dev, **kw)
                 for r in (1.0, 10.0))


def sw_transforms_controller(device):
    """The stagewise controller of phase 21's transforms hold (N=8, wave
    16): soft rows, move blocking, a terminal set and an input budget
    Σu ≤ −0.5 at once, built."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.models import (
        di_default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    spec = BnbSpec(capacity=128, wave_size=16, qp_iters=300, max_waves=24,
                   probe_iters=600)
    A_v = np.zeros((1, 8 * 3))
    A_v[0, 0::3] = 1.0
    c = MpcController(switched_double_integrator(), 8, di_default_weights(),
                      solver="stagewise", bnb_spec=spec, device=device)
    c.set_soft_constraints([1, 9], lin_pen=5.0, quad_pen=1.0)
    c.set_move_blocking([0, 0, 1, 1, 2, 2, 3, 3])
    c.set_terminal_constraint(np.array([[1.0, 0.0]]), np.array([1.0]))
    c.set_extra_constraints(A_v, np.array([-0.5]))
    return c.build()


def k4_frames(dev):
    """(tag, key, prep, P) of every shape phase 20 holds K4 at: config 6's
    long-arm frame (a wave of 8 nodes × S=8) and its parity arm's (a wave
    of 32 × S=2); the frames of phase 21's other stagewise paths at their
    wave: the served double integrator (N=10, P=32) and the transforms
    hold (soft rows, blocking, terminal set, budget row; N=8, P=16); each
    at ρ and ρ·10; a single double-integrator frame at N=40 with P = 1,
    33, 257; the PWA hull model (b=13) at N=20."""
    from pyhybridcontrol_tpu_torch import serve
    from pyhybridcontrol_tpu_torch.models import (
        di_default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.models.pwa_examples import (
        pwa_spring_mld, pwa_weights)
    from pyhybridcontrol_tpu_torch.ops.stagewise import prepare_stagewise

    tree_s, tree_l = config6_trees()
    long = config6_preps(dev, tree_l, config6_extra(CFG6_N))
    out = []
    # the long arm's wave (8 nodes × S=8), and one rank's half of it when
    # the tree's scenarios are split over 2 ranks (multi-device phase)
    for tag, key, preps, P in (
            ("config 6 long arm", "cfg6", long, 64),
            ("config 6 long arm, a rank's half", "cfg6_rank", long, 32),
            ("config 6 parity arm", "cfg6_parity",
             config6_preps(dev, tree_s), 64)):
        for swt, rho in zip(preps, ("ρ", "ρ·10")):
            out.append((f"{tag} {rho}", key if rho == "ρ" else key + "_stiff",
                        swt.sw, P))
    for tag, key, c in (
            ("served double integrator", "serve_sw", serve.make_controller(
                "double_integrator", "stagewise", dev.type)),
            ("transforms hold", "transforms", sw_transforms_controller(dev))):
        for sw, rho in ((c._sw, "ρ"), (c._sw_probe, "ρ·10")):
            out.append((f"{tag} {rho}", key if rho == "ρ" else key + "_stiff",
                        sw, c.bnb_spec.wave_size))
    sw40 = prepare_stagewise(switched_double_integrator(), 40,
                             di_default_weights(), device=dev)
    for P in (1, 33, 257):
        out.append((f"double integrator N=40", f"n40_p{P}", sw40, P))
    hull = prepare_stagewise(pwa_spring_mld(on_off=True, formulation="hull"),
                             20, pwa_weights(), device=dev)
    out.append(("PWA hull N=20", "hull", hull, 64))
    return out


# the wider instantiations (bmax 32, 64, 128): random factors of a stable
# recursion, held staged and through L2, and timed (TIMINGS) beside the
# battery fleets' factors (K4_FLEETS)
K4_WIDE = ((20, 8), (40, 6), (100, 4))        # (b, N), each at P=8
# (batteries, N) of the fleets whose factors K4 is timed on at P=8:
# battery_fleet's (b=32) and phase 37's at b=64 and b=128
K4_FLEETS = ((8, 96), (16, 48), (32, 24))


def k4_wide(dev, rng):
    """(tag, factors, P) of the wide shapes: L, U⁻¹, C with entries of
    N(0, 0.3²/b), so the sweeps neither grow nor vanish."""
    import torch

    out = []
    for b, N in K4_WIDE:
        f = torch.as_tensor(rng.normal(0.0, 0.3 / b ** 0.5, (3, N, b, b)),
                            dtype=torch.float32, device=dev)
        out.append((f"random factors b={b}, N={N}", tuple(f.unbind(0)), 8))
    return out


def k4_work(P, N, b):
    """(bytes, {type: operations}) of one K4 call: r and x once, the three
    factor arrays once; per problem and stage b² FMAs forward and 2·b²
    backward, and 2·b subtractions."""
    return (4 * (2 * P * N * b + 3 * N * b * b),
            dict(fp32=P * N * (6 * b * b + 2 * b)))


# cycles of one dependent sweep stage on an H100 (tools/sweep_chain.py, one
# warp at b=5): the stage (5 shuffles of the previous stage's vector and a
# chain of 5 FMAs) and the chain of 5 FMAs alone
SWEEP_STAGE_CYCLES, SWEEP_FMA5_CYCLES = 51.5, 25.8


def k4_chain_ms(N, b):
    """Floor of one problem's dependent chain in K4: 2·N stages, each the
    measured cycles of a stage at b=5 with its FMA chain scaled to b
    FMAs, at the 1.98 GHz boost clock."""
    stage = SWEEP_STAGE_CYCLES + SWEEP_FMA5_CYCLES * (b - 5) / 5
    return 1e3 * 2 * N * stage / 1.98e9


def horizon_chain_ms(N, b, C):
    """Floor of the horizon variant's parallel sweep a problem and
    iteration: each window's 2·⌈N/C⌉ stages and the 2·(C−1) carry steps
    (a b×b product each, costed as a stage), K4's stage as
    ``k4_chain_ms``."""
    return k4_chain_ms(-(-N // C) + C - 1, b)


def dense_K_of(factors):
    """K as a dense (N·b, N·b) fp64 matrix from its block LU factors
    (L, U⁻¹, C): the inverse of K⁻¹, the plain sweeps applied to the unit
    vectors (for factors with no prep behind them)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    N, b = factors[0].shape[:2]
    n = N * b
    f64 = tuple(f.double() for f in factors)
    E = torch.eye(n, dtype=torch.float64, device=factors[0].device)
    Kinv = tsw._solve_K(None, E.reshape(n, N, b), f64).reshape(n, n).T
    return torch.linalg.inv(Kinv)


def k4_wide_timed(rec, pre, tag, factors, r, K):
    """K4 at a wide shape, timed into ``rec`` under ``pre``: alone and
    around its wrapper, the plain sweeps, the bound (``k4_work``), the
    chain floor and ``torch.linalg.lu_solve`` on the dense LU of K (fp32)
    for the same right-hand sides."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    P, N, b = r.shape
    pl = cs.plan_sweep(P, N, b)
    print(f"  {tag}, P={P} (bmax {pl.bmax}, "
          + (f"staged, {pl.warps} warps a block" if pl.staged
             else f"a ring of {pl.ring} blocks a warp, 1 warp a block")
          + f", {pl.smem} bytes):", flush=True)
    timed(rec, pre, lambda: cs.sw_solve_k_cuda(r, factors),
          lambda: tsw._solve_K(None, r, factors), k4_work(P, N, b))
    rec[pre + "chain_ms"] = k4_chain_ms(N, b)
    LU, piv = torch.linalg.lu_factor(K.float())
    rhs = r.reshape(P, N * b).T.contiguous()
    rec[pre + "library_ms"] = cuda_ms(
        lambda: torch.linalg.lu_solve(LU, piv, rhs))
    print(f"    chain floor {rec[pre + 'chain_ms']:.4f} ms (2N={2 * N} "
          f"stages); torch.linalg.lu_solve on the dense LU of K "
          f"({N * b}², {P} right-hand sides): "
          f"{rec[pre + 'library_ms']:.3f} ms", flush=True)


def dense_K(sw):
    """K = P + σI + Aᵀdiag(ρ)A of a stagewise prep as a dense (N·b, N·b)
    fp64 matrix, applied to the unit vectors through the operators."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    sw64 = tsw.stagewise_double(sw)
    n = sw.N * sw.b
    E = torch.eye(n, dtype=torch.float64, device=sw.device).reshape(
        n, sw.N, sw.b)
    KE = (tsw._apply_P(sw64, E) + sw.sigma * E
          + tsw._apply_AT(sw64, sw64.rho_rows * tsw._apply_A(sw64, E)))
    return KE.reshape(n, n).T


def k4_sweep(sw, t):
    """K⁻¹t through K4 (the sweep of the torch loop K5 replaced)."""
    from pyhybridcontrol_tpu_torch.ops.cuda_stagewise import sw_solve_k_cuda

    return sw_solve_k_cuda(t, sw.factors)


@contextlib.contextmanager
def torch_loop(sweep=None):
    """Inside: the stagewise solves on the card run the torch loop
    (``_admm_iterations``) with ``sweep`` (``k4_sweep``, or by default the
    plain sweeps ``_solve_K``, torch ops on the card) instead of K5."""
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    orig = tsw.sw_admm_cuda
    tsw.sw_admm_cuda = lambda *a: tsw._admm_iterations(
        *a, sweep=sweep or tsw._solve_K)
    try:
        yield
    finally:
        tsw.sw_admm_cuda = orig


PLAIN_SWEEPS = ("_solve_K", "_solve_K_assoc", "_solve_K_windowed")


@contextlib.contextmanager
def refused(names, what):
    """Inside: the functions ``names`` of ops/stagewise.py raise (``what``
    says what a stagewise path on the card that reached them ran)."""
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    orig = [getattr(tsw, n) for n in names]

    def refuse(*a, **kw):
        raise AssertionError(f"a stagewise solve on the card ran {what}")

    for n in names:
        setattr(tsw, n, refuse)
    try:
        yield
    finally:
        for n, f in zip(names, orig):
            setattr(tsw, n, f)


def no_plain_sweep():
    """Inside: the plain loop and the plain sweeps raise, so a stagewise
    path on the card that reached them would fail."""
    return refused(("_admm_iterations",) + PLAIN_SWEEPS,
                   "the plain loop or sweeps, not K5")


@contextlib.contextmanager
def k5_calls():
    """Inside: the arguments of every K5 launch of the stagewise solves
    are recorded in the list yielded (the launches run), their keywords
    (the parallel sweep's) in its ``kw``."""
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    class Calls(list):
        kw: list

    orig, calls = tsw.sw_admm_cuda, Calls()
    calls.kw = []

    def record(*a, **kw):
        calls.append(a)
        calls.kw.append(kw)
        return orig(*a, **kw)

    tsw.sw_admm_cuda = record
    try:
        yield calls
    finally:
        tsw.sw_admm_cuda = orig


@contextlib.contextmanager
def k5_launch_log():
    """Inside: every K5 launch of the stagewise solves is logged in the list
    yielded, as a dict: P, iters, the parallel sweep, the plan's variant
    and clusters, the clusters the card holds at once (a horizon plan's
    ``horizon_capacity``, a group mean's ``admm_cluster_capacity``) and,
    once the block has ended, the device time between CUDA events
    recorded around the call (ms)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    orig, log, events = tsw.sw_admm_cuda, [], []

    def record(*a, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = orig(*a, **kw)
        e1.record()
        events.append((e0, e1))
        P, pl = k5_plan_of(a, kw.get("variant"),
                           parallel=bool(kw.get("parallel")))
        sw = a[0]
        log.append(dict(
            P=P, iters=int(a[10]), parallel=bool(kw.get("parallel")),
            variant=pl.variant, cluster=pl.cluster, windows=pl.windows,
            held=(cs.horizon_capacity(sw.N, sw.b, sw.m_k, pl, a[1].device)
                  if pl.variant == "horizon" else next(
                      (v for k, v in sw.cache.items()
                       if k[0] == "k5_clusters" and k[1] == pl), None))))
        return out

    tsw.sw_admm_cuda = record
    try:
        yield log
    finally:
        tsw.sw_admm_cuda = orig
        torch.cuda.synchronize()
        for rec, (e0, e1) in zip(log, events):
            rec["ms"] = e0.elapsed_time(e1)


def launch_log_line(log) -> str:
    """K5's launches of a ``k5_launch_log`` by (iters, sweep): count, the
    sum and the range of their device times; with P, the clusters and the
    card's clusters at once."""
    groups = {}
    for r in log:
        groups.setdefault((r["iters"], r["parallel"]), []).append(r["ms"])
    shapes = sorted({(r["P"], r["variant"], r["cluster"], r["held"],
                      r["windows"]) for r in log}, key=str)
    return (f"K5 {len(log)} launches, {sum(r['ms'] for r in log):.1f} ms "
            "(events): " + "; ".join(
                f"{len(v)} × {it} it{' parallel' if par else ''} "
                f"{sum(v):.1f} ms ({min(v):.2f}–{max(v):.2f})"
                for (it, par), v in sorted(groups.items()))
            + " at " + ", ".join(f"P={P} {v} C={C}"
                                 + (f", {w} windows" if w else "")
                                 + (f" ({h} clusters at once)" if h else "")
                                 for P, v, C, h, w in shapes))


def long_warm_reading(name, solve, path="long_horizon") -> dict:
    """A warm solve of ``path`` read twice: once on the host clock and
    once under torch.profiler (device operations, busy time, the idle
    share against that run's own wall time), each with its K5 launches
    logged (``k5_launch_log``). Prints one line a run and returns the
    profile, with both wall times and both logs."""
    import torch

    from pyhybridcontrol_tpu_torch.profile_serve import profile_request

    with k5_launch_log() as timed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    with k5_launch_log() as profiled:
        prof = profile_request(solve)
    prof.update(ms=ms, timed_launches=timed, profiled_launches=profiled,
                idle_share=1.0 - prof["device_busy_ms"] / prof["wall_ms"])
    print(f"  {path}, {name} again (warm): {ms:.1f} ms; "
          + launch_log_line(timed), flush=True)
    print(f"  {path}, {name} under torch.profiler: {prof['wall_ms']:.1f}"
          f" ms, {prof['device_ops']} device operations, busy "
          f"{prof['device_busy_ms']:.1f} ms: idle share "
          f"{prof['idle_share']:.4f}; K5 {prof['k5_launches']} launches, "
          f"{prof['k5_device_ms']:.1f} ms on the device (profiler); "
          + launch_log_line(profiled), flush=True)
    return prof


def k5_cert_near(args, ref, shape):
    """Mask (``shape``, the solve's certificate's) of the problems of a K5
    call (``args``, those of ``sw_admm_cuda``) whose certificate ratios,
    from the plain loop's carries ``ref``, lie within CERT_BAND of a
    threshold (a tree node: in any of its scenarios): there K5's bits may
    differ (certs_held, CERT_SHARE), as K1's do on the real frames."""
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    sw, l, u, ext_u = args[0], args[2], args[3], args[9]
    r = tsw._certificate(sw, ref[3], ref[6], l, u, ext_u)[1]
    near = ((r >= CERT_EPS / CERT_BAND) & (r <= CERT_EPS * CERT_BAND))
    while near.dim() > len(shape):
        near = near.any(-1)
    return near.reshape(shape)


@contextlib.contextmanager
def k5_replayed(out):
    """Inside: K5's launch in the stagewise solves is replaced by ``out``,
    carries the caller computed (the plain loop's), so that a solve gives
    the certificate and residuals of those carries."""
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    orig = tsw.sw_admm_cuda
    tsw.sw_admm_cuda = lambda *a: out
    try:
        yield
    finally:
        tsw.sw_admm_cuda = orig


@contextlib.contextmanager
def solve_calls():
    """Inside: every stagewise relaxation or probe (a call of
    ``stagewise_admm_solve`` from the B&B backends) is counted in the
    list yielded."""
    from pyhybridcontrol_tpu_torch.ops import stagewise_tree as tst
    from pyhybridcontrol_tpu_torch.solver import bnb_stagewise as bsw

    orig, count = tst.stagewise_admm_solve, [0]

    def counted(*a, **kw):
        count[0] += 1
        return orig(*a, **kw)

    tst.stagewise_admm_solve = bsw.stagewise_admm_solve = counted
    try:
        yield count
    finally:
        tst.stagewise_admm_solve = bsw.stagewise_admm_solve = orig


def wave_boxes(be, f, h, W, rng, fix_frac):
    """(f, h) broadcast to a wave of W nodes of the backend ``be`` and node
    boxes with ``fix_frac`` of its branching coordinates fixed at random
    (node 0 the root)."""
    import torch

    fb, hb = be.broadcast_data(f, h, W)
    lb = be.lb.expand(W, -1).clone()
    ub = be.ub.expand(W, -1).clone()
    reps = torch.as_tensor(be.binary_idx, device=lb.device)
    fix = torch.as_tensor(rng.random((W, len(reps))) < fix_frac,
                          device=lb.device)
    fix[0] = False
    val = torch.as_tensor(rng.integers(0, 2, (W, len(reps))),
                          dtype=lb.dtype, device=lb.device)
    lb[:, reps] = torch.where(fix, val, lb[:, reps])
    ub[:, reps] = torch.where(fix, val, ub[:, reps])
    return fb, hb, lb, ub


def node_wave(swt, ext_u, rng, W, fix_frac):
    """A wave of W nodes of a stagewise tree: the backend, the broadcast
    (f, h) and node boxes with ``fix_frac`` of the representatives fixed
    at random (node 0 the root)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        StagewiseTreeBackend, assemble_stagewise_tree,
        pack_stagewise_tree_data)

    x0 = torch.tensor(X0_6, device=swt.probs.device)
    be = StagewiseTreeBackend(swt, ext_u=ext_u)
    return (be, *wave_boxes(be, *pack_stagewise_tree_data(
        *assemble_stagewise_tree(swt, x0)), W, rng, fix_frac))


def phase_k4(dev, rng, rec):
    """K4 against its plain version (``_solve_K``, torch ops) on the card at
    every shape of ``k4_frames``, staged and (at config 6's long arm) with
    the factors read through L2; then the whole stagewise tree relaxation
    (150 iterations, "main" limits) and the 1000-iteration probe at ρ·10
    on config 6's frame, the torch loop with K4 (the path K5 replaced)
    against the torch loop with the plain sweeps, certificate bits
    identical. Times of K4 alone, of its wrapper and of the plain sweeps,
    its bound, its chain floor and ``torch.linalg.lu_solve`` on the dense
    LU of K at every shape, the wide ones (``K4_WIDE``, and the battery
    fleets' factors of ``K4_FLEETS``, whose difference from the plain
    sweeps is printed) included (``k4_wide_timed``)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw
    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        assemble_stagewise_tree_ext)

    print("K4 (stagewise sweep) vs plain:", flush=True)
    frames = k4_frames(dev)
    for tag, key, sw, P in frames:
        N, b = sw.N, sw.b
        r = torch.as_tensor(rng.normal(size=(P, N, b)), dtype=torch.float32,
                            device=dev)
        ref = tsw._solve_K(sw, r)
        for staged in ((None, False) if key == "cfg6" else (None,)):
            pl = cs.plan_sweep(P, N, b, staged)
            x = cs.sw_solve_k_cuda(r, sw.factors, staged=staged)
            held(f"{tag} P={P} N={N} b={b} (bmax {pl.bmax}, "
                 f"{'staged' if pl.staged else 'through L2'}, {pl.warps} "
                 "warps a block)", "sweep", {"x": (x, ref)})
            rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0),
                                     float((x - ref).abs().max()))

        def wrapper():
            return cs.sw_solve_k_cuda(r, sw.factors)

        def plain():
            return tsw._solve_K(sw, r)

        if not TIMINGS:
            continue
        pre = "" if key == "cfg6" else key + "_"
        by = timed(rec, pre, wrapper, plain, k4_work(P, N, b))
        rec[pre + "chain_ms"] = k4_chain_ms(N, b)
        if key == "cfg6":
            rec["bound_by"] = by
        K = dense_K(sw).float()
        LU, piv = torch.linalg.lu_factor(K)
        rhs = r.reshape(P, N * b).T.contiguous()
        rec[pre + "library_ms"] = cuda_ms(
            lambda: torch.linalg.lu_solve(LU, piv, rhs))
        print(f"  chain floor {rec[pre + 'chain_ms']:.4f} ms (2N={2 * N} "
              f"stages); torch.linalg.lu_solve on the dense LU of K "
              f"({N * b}², {P} right-hand sides): "
              f"{rec[pre + 'library_ms']:.3f} ms", flush=True)

    for tag, factors, P in k4_wide(dev, rng):
        N, b = factors[0].shape[:2]
        r = torch.as_tensor(rng.normal(size=(P, N, b)), dtype=torch.float32,
                            device=dev)
        ref = tsw._solve_K(None, r, factors)
        staged = cs.plan_sweep(P, N, b).staged
        for st in ((True, False) if staged else (False,)):
            pl = cs.plan_sweep(P, N, b, st)
            held(f"{tag} P={P} (bmax {pl.bmax}, "
                 f"{'staged' if st else 'through L2'})", "sweep_wide",
                 {"x": (cs.sw_solve_k_cuda(r, factors, staged=st), ref)})
        if TIMINGS:
            k4_wide_timed(rec, f"wide_b{b}_N{N}_", tag, factors, r,
                          dense_K_of(factors))
    # the fleets' factors (K5's sweep at battery_fleet and phase 37's b=64
    # and b=128; K5 is held there): timed, with K4's difference from the
    # plain sweeps printed (the right-hand sides from a generator of their
    # own, so that the holds above and below keep their inputs)
    frng = phase_rng("k4_fleets")
    for M, N in (K4_FLEETS if TIMINGS else ()):
        sw = fleet_controller(M, N, dev)[0]._sw
        r = torch.as_tensor(frng.normal(size=(8, N, sw.b)),
                            dtype=torch.float32, device=dev)
        ref = tsw._solve_K(sw, r)
        err = float((cs.sw_solve_k_cuda(r, sw.factors) - ref).abs().max()
                    / ref.abs().max())
        k4_wide_timed(rec, f"fleet{M}_", f"{M} batteries' factors, N={N}, "
                      f"b={sw.b} (max |Δ| / max |x| against the plain "
                      f"sweeps {err:.2e})", sw.factors, r, dense_K(sw))

    tree_l = config6_trees()[1]
    swt, swtp = config6_preps(dev, tree_l, config6_extra(CFG6_N))
    x0 = torch.tensor(X0_6, device=dev)
    eu = assemble_stagewise_tree_ext(swt, x0)
    W = CFG6_SPEC["wave_size"]
    be, fb, hb, lb, ub = node_wave(swt, eu, rng, W, K4_HOLD_FIX)
    iters, piters = CFG6_SPEC["qp_iters"], CFG6_SPEC["probe_iters"]

    def relax():
        return be.solve(fb, hb, lb, ub, iters)

    with torch_loop(k4_sweep):
        got = relax()
        t_k4 = wall_median(relax) if TIMINGS else float("nan")
    with torch_loop():
        ref = relax()
        t_plain = wall_median(relax) if TIMINGS else float("nan")
    compare(f"config 6 relaxation, {W} nodes × S={CFG6_S}, {iters} it",
            got, ref, rec, "main")
    # the probe: every representative fixed to the plain relaxation's
    # rounded value, at ρ·10, warm from the relaxation (both from ref's)
    reps = torch.as_tensor(be.binary_idx, device=dev)
    pv = torch.round(torch.clamp(ref.x[:, reps], 0.0, 1.0))
    lbp, ubp = lb.clone(), ub.clone()
    lbp[:, reps] = ubp[:, reps] = pv
    bp = type(be)(swtp, ext_u=eu)
    warm = (ref.x, ref.z, ref.y)
    with torch_loop(k4_sweep):
        got_p = bp.solve(fb, hb, lbp, ubp, piters, warm=warm)
    with torch_loop():
        ref_p = bp.solve(fb, hb, lbp, ubp, piters, warm=warm)
    compare(f"config 6 probe at ρ·10, {piters} it", got_p, ref_p, rec,
            "main")
    print(f"  the relaxation ({iters} it, P={W * CFG6_S}), each warm, median "
          f"of 3: {t_k4:.3f} s through the torch loop with K4, {t_plain:.3f} "
          "s with the plain sweeps", flush=True)


# ---- K6: the sweep at any b and over windows -------------------------------

# K6's holds (phase "K6 vs plain", after K4's): (tag, b, N, the factors:
# "cfg6" config 6's long arm, "fleet" fleet_controller(b/4, N)'s, "random"
# ``random_factors``), each at P = K6_BATCHES (and the fleet_b160 path's
# wave, P=8, at b=160), sequential and over ``any_windows(N)`` windows (16,
# 14, 7, 7, 7, 7, 5: N a multiple of none)
K6_SHAPES = (("config 6 long arm", 5, CFG6_N, "cfg6"),
             ("8 batteries", 32, 96, "fleet"),
             ("32 batteries", 128, 24, "fleet"),
             ("random", 129, 24, "random"),
             ("random, odd", 137, 20, "random"),
             ("40 batteries", 160, 24, "fleet"),
             ("random", 256, 12, "random"))
K6_BATCHES = (1, 64)
# the shape fleet_b160's relaxations give K6 (a wave of 8 nodes): the
# kernels line's times, and every variant forced there ("ring" and "l2",
# sequential and over windows, the windows also in five launches)
K6_MAIN = (160, 24, 8)
# the shapes no K6_SHAPES row takes to a plan variant: (tag, b, N, P) of
# random factors; b=700 runs "l2" (no two row slices fit a CTA)
K6_VARIANT_HOLDS = (("random, l2", 700, 4, 3),)
# the third class of shapes K5 has no instantiation for: a tree of
# K6_TREE_S scenarios of config 6's ω double integrator (branching at step
# 1, its budget row), N=K6_TREE_N, b=5: one relaxation of K6_TREE_ITERS
# iterations through the route, both sweeps
K6_TREE_S, K6_TREE_N, K6_TREE_ITERS = 272, 8, 20


def random_factors(rng, N, b, dev, dtype=None):
    """(L, U⁻¹, C) on ``dev`` (fp32, or ``dtype``) of a random symmetric
    positive definite block-tridiagonal K (diagonal blocks I + GGᵀ/b,
    off-diagonal blocks of N(0, 0.3²/b)), by the host fp64 block LU
    (tests/test_torch_stagewise_any.py takes them in fp64)."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.ops.stagewise import block_lu

    G = rng.normal(size=(N, b, b))
    diag = np.eye(b) + G @ G.transpose(0, 2, 1) / b
    off = rng.normal(0.0, 0.3 / b ** 0.5, (N, b, b))
    off[0] = 0.0
    return tuple(torch.as_tensor(f, dtype=dtype or torch.float32,
                                 device=dev) for f in block_lu(diag, off))


def k6_factors(dev, rng, key, b, N):
    """A prep-like namespace (N, ``factors`` and the ``cache`` that
    ``cuda_stagewise.any_maps`` fills once) of K6_SHAPES' ``key``."""
    if key == "cfg6":
        f = config6_preps(dev, config6_trees()[1],
                          config6_extra(CFG6_N))[0].sw.factors
    elif key == "fleet":
        f = fleet_controller(b // 4, N, dev)[0]._sw.factors
    else:
        f = random_factors(rng, N, b, dev)
    return types.SimpleNamespace(N=N, factors=f, cache={})


def k6_windowed_bound_ms(P, N, b, C):
    """The bound of K6 over C windows with its windowed work counted too
    (``k4_work``, the function's own work and what ``bound_ms`` counts,
    plus ``window_overhead``: the carries composed once, C−1 products each
    way; K6 composes each window's carry in that window's CTA, c products
    for window c, and those repeats are not counted)."""
    (nb, ops), (ob, oo) = k4_work(P, N, b), window_overhead(P, N, b, C)
    return bound(nb + ob, dict(fp32=ops["fp32"] + oo["fp32"]))[0]


def k6_chain_ms(N, b, C):
    """The chain floor of one problem in K6: ``k4_chain_ms``'s 2·N stages,
    over C > 1 windows ``horizon_chain_ms``'s (a window's stages and the
    carry steps)."""
    return k4_chain_ms(N, b) if C == 1 else horizon_chain_ms(N, b, C)


def k6_smem_held(pl, N, b):
    """The plan's shared memory a CTA against the kernel's own count
    (``phc_k6_smem_bytes``, csrc/stagewise_any.cu)."""
    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    got = load_library("stagewise_any").phc_k6_smem_bytes(
        cs.ANY_VARIANTS.index(pl.variant), N, b, pl.windows, pl.lanes,
        pl.rows, pl.problems, pl.ring)
    check(got == pl.smem, f"K6 at N={N}, b={b}: the plan's {pl.smem} bytes "
          f"a CTA, the kernel's {got}")


def k6_plan_text(pl, launches):
    """A K6 plan as phase 40 prints it."""
    if pl.variant == "narrow":
        return (f"narrow, {pl.problems} problems and {pl.windows} windows a "
                f"CTA of {pl.threads} threads, {pl.lanes} lanes a slot, "
                f"{pl.smem} bytes, {launches} launch")
    return (f"{pl.variant}, clusters of {pl.cluster} CTAs of {pl.rows} rows, "
            f"{pl.problems} problems a cluster, ring "
            f"{pl.ring} slices, {pl.threads} threads, {pl.smem} bytes, "
            f"{pl.clusters} clusters, {launches} launch"
            + ("es" if launches > 1 else ""))


def k6_stamps(rec, pre, r, sw, w, maps):
    """k6_wide's cycles a step by part (thread 0 of every CTA: waiting for
    its ring slot, its FMAs, its DSMEM stores, the barrier) at one shape,
    into ``rec`` under ``pre``."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs

    st = torch.zeros(5, dtype=torch.int64, device=r.device)
    cs._k6_launch(r, sw.factors, w, maps if w > 1 else None, stamps=st)
    s = st.tolist()
    split = {k: s[i] / max(s[4], 1) for i, k in enumerate(
        ("ring_wait", "fma", "dsmem", "barrier"))}
    rec[pre + "stage_cycles"] = split
    print("    cycles a step (thread 0 of each CTA): " + ", ".join(
        f"{k} {v:.0f}" for k, v in split.items()) + f" ({s[4]} steps)",
        flush=True)


def k6_forced(dev, rng, rec, sw, r, maps, C, plan_out):
    """Every variant forced at fleet_b160's wave (K6_MAIN): "ring" and
    "l2", sequential and over C windows, the windows also in five launches;
    each within "k6" of its plain version and bitwise the plan's output
    (the same FMAs in the same order), timed alone."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    b, N, P = K6_MAIN
    bounds = cs.horizon_windows(N, C)
    for w in (1, C):
        ref = (tsw._solve_K(sw, r) if w == 1
               else tsw._solve_K_windowed(sw, r, bounds))
        for v in ("ring", "l2"):
            for multi in ((False, True) if w > 1 else (False,)):
                def run(v=v, multi=multi, w=w):
                    return cs._k6_launch(r, sw.factors, w,
                                         maps if w > 1 else None, v, multi)
                got, n = run()
                pl = cs.plan_sweep_any(P, N, b, w, v)
                k6_smem_held(pl, N, b)
                tag = (f"fleet_b160's wave forced {v}{' in five launches' if multi else ''}, "
                       f"C={w} ({k6_plan_text(pl, n)})")
                held(tag, "k6", {"x": (got, ref)})
                check(torch.equal(got.view(torch.int32),
                                  plan_out[w].view(torch.int32)),
                      f"{tag}: not bitwise the plan's output")
                check(n == (5 if multi else 1),
                      f"{tag}: {n} launches")
                if TIMINGS:
                    key = f"b{b}_N{N}_P{P}_C{w}_{v}{'_multi' if multi else ''}_kernel_ms"
                    rec[key] = kernel_ms(run)
                    print(f"    kernel alone {rec[key]:.4f} ms", flush=True)


def phase_k6(dev, rng, rec):
    """K6 against its plain versions on the card (``_solve_K`` for one
    window, ``_solve_K_windowed`` over ``any_windows(N)``) at every shape
    of K6_SHAPES ("k6" at the preps' factors, "k6_random" at the random
    ones) and of K6_VARIANT_HOLDS, each with its plan (variant, cluster,
    ring, problems a cluster; its shared memory held against the kernel's
    count) and the launches a call; each timed alone,
    around its wrapper and as the plain version, beside its bound
    (``k4_work``, the function's own work; over windows also
    ``k6_windowed_bound_ms``), its chain floor (``k6_chain_ms``) and
    ``torch.linalg.lu_solve`` on the dense LU of K (fp32) for the same
    right-hand sides; at fleet_b160's wave k6_wide's cycles by part
    (``k6_stamps``) and every variant forced (``k6_forced``). Then the
    third class (``k6_tree_hold``)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    print("K6 (stagewise sweep at any b) vs plain:", flush=True)
    shapes = [(tag, b, N, key, K6_BATCHES + ((K6_MAIN[2],)
                                             if (b, N) == K6_MAIN[:2] else ()))
              for tag, b, N, key in K6_SHAPES]
    shapes += [(tag, b, N, "random", (P,)) for tag, b, N, P in
               K6_VARIANT_HOLDS]
    variants = set()
    for tag, b, N, key, batches in shapes:
        sw = k6_factors(dev, rng, key, b, N)
        C = cs.any_windows(N)
        bounds = cs.horizon_windows(N, C)
        maps = cs.any_maps(sw, C)
        regime = "k6_random" if key == "random" else "k6"
        K = None
        for P in batches:
            r = torch.as_tensor(rng.normal(size=(P, N, b)),
                                dtype=torch.float32, device=dev)
            plan_out = {}
            for w in (1, C):
                def wrapper(w=w):
                    return cs.sw_solve_k_any_cuda(
                        r, sw.factors, windows=w,
                        maps=maps if w > 1 else None)

                def plain(w=w):
                    return (tsw._solve_K(sw, r) if w == 1 else
                            tsw._solve_K_windowed(sw, r, bounds))

                pl = cs.plan_sweep_any(P, N, b, w)
                k6_smem_held(pl, N, b)
                got, n = cs._k6_launch(r, sw.factors, w,
                                       maps if w > 1 else None)
                plan_out[w] = got
                ref = plain()
                variants.add((pl.variant, w > 1, n))
                held(f"{tag} b={b} N={N} P={P} C={w} ({k6_plan_text(pl, n)})",
                     regime, {"x": (got, ref)})
                rec["max_abs_err"] = max(rec.get("max_abs_err", 0.0),
                                         float((got - ref).abs().max()))
                if not TIMINGS:
                    continue
                pre = f"b{b}_N{N}_P{P}_C{w}_"
                rec[pre + "plan"] = k6_plan_text(pl, n)
                by = timed(rec, pre, wrapper, plain, k4_work(P, N, b))
                rec[pre + "chain_ms"] = k6_chain_ms(N, b, w)
                if w > 1:
                    rec[pre + "windowed_bound_ms"] = k6_windowed_bound_ms(
                        P, N, b, w)
                    print(f"    with the windowed work counted too: "
                          f"{rec[pre + 'windowed_bound_ms']:.3g} ms",
                          flush=True)
                if pl.variant != "narrow" and (b, N, P) == K6_MAIN:
                    k6_stamps(rec, pre, r, sw, w, maps)
                if (b, N, P, w) == K6_MAIN + (1,):
                    rec["bound_by"] = by
                    for k in ("ms", "kernel_ms", "plain_ms", "bound_ms"):
                        rec[k] = rec[pre + k]
            if (b, N, P) == K6_MAIN:
                k6_forced(dev, rng, rec, sw, r, maps, C, plan_out)
            if not TIMINGS:
                continue
            K = dense_K_of(sw.factors) if K is None else K
            LU, piv = torch.linalg.lu_factor(K.float())
            rhs = r.reshape(P, N * b).T.contiguous()
            lib = f"b{b}_N{N}_P{P}_library_ms"
            rec[lib] = cuda_ms(lambda: torch.linalg.lu_solve(LU, piv, rhs))
            if (b, N, P) == K6_MAIN:
                rec["library_ms"] = rec[lib]
            print(f"  b={b} N={N} P={P}: chain floor "
                  f"{k6_chain_ms(N, b, 1):.4f} ms (C=1) / "
                  f"{k6_chain_ms(N, b, C):.4f} ms (C={C}); "
                  f"torch.linalg.lu_solve on the dense LU of K ({N * b}², "
                  f"{P} right-hand sides): {rec[lib]:.3f} ms", flush=True)
    # every variant of the plan held at some shape: narrow, ring and l2,
    # sequential and over windows, and the windowed k6_wide sweep both in
    # one launch and in five
    for want in (("narrow", False), ("narrow", True), ("ring", False),
                 ("ring", True), ("l2", False), ("l2", True)):
        check(any(v[:2] == want for v in variants),
              f"K6: no hold reached the {want[0]} variant "
              f"{'over windows' if want[1] else 'sequential'}")
    for n in (1, 5):
        check(any(v[0] != "narrow" and v[1] and v[2] == n
                  for v in variants),
              f"K6: no windowed k6_wide hold ran in {n} launch(es)")
    k6_tree_hold(dev, rng, rec)


def k6_tree_hold(dev, rng, rec):
    """The third class of shapes K5 has no instantiation for: a tree past
    K5's clusters (K6_TREE_S scenarios at b=5; ``k5_plan`` None), one
    relaxation of K6_TREE_ITERS iterations from cold through the route
    (``_admm_route``: the torch loop with K4's sweep, or with
    ``parallel_sweeps`` K6's windowed one) against ``_admm_iterations``
    with the plain sweep (``_solve_K``; ``_solve_K_windowed`` on the same
    windows) on the same CUDA tensors, within K5's limits ("k5_flex",
    "k5_par"); the route's kernel launched once an iteration, K5 never."""
    import torch

    from pyhybridcontrol_tpu_torch.models import di_default_weights
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw
    from pyhybridcontrol_tpu_torch.ops.scenario_tree import ScenarioTree
    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        assemble_stagewise_tree, assemble_stagewise_tree_ext,
        prepare_stagewise_tree)

    S, N = K6_TREE_S, K6_TREE_N
    tree = ScenarioTree.from_branching(rng.normal(0.0, 0.3, (S, N, 1)),
                                       branch_steps=(1,))
    swt = prepare_stagewise_tree(omega_model(), tree, di_default_weights(),
                                 extra=config6_extra(N), device=dev)
    sw, M = swt.sw, swt.M
    x0 = torch.tensor(X0_6, device=dev)
    q, l, u = assemble_stagewise_tree(swt, x0)
    eu = assemble_stagewise_tree_ext(swt, x0)
    batch = torch.broadcast_shapes(q.shape[:-2], l.shape[:-2])
    z_e = torch.clamp_max(q.new_zeros(batch + (sw.n_ext,)), eu)
    carries = (sw, q, l, u, q.new_zeros(batch + (sw.N, sw.b)),
               torch.clamp(q.new_zeros(batch + (sw.N, sw.m_k)), l, u),
               q.new_zeros(batch + (sw.N, sw.m_k)), z_e,
               torch.zeros_like(z_e), eu, K6_TREE_ITERS, M)
    C = cs.any_windows(N)
    for par, kernel, regime in ((False, "stagewise_k4", "k5_flex"),
                                (True, "stagewise_k6", "k5_par")):
        check(cs.k5_plan(N, sw.b, sw.m_k, S, sw.n_blk, sw.n_ext, sw.n_cons,
                         True, par) is None,
              f"a tree of S={S}: K5 plans it")
        run, kw = tsw._admm_route(sw, dev, par, M)
        ca.reset_launch_counts()
        got = run(*carries, **kw)
        torch.cuda.synchronize()
        launched = {k: v for k, v in ca.LAUNCHES.items() if v}
        bounds = cs.horizon_windows(N, C)
        plain = ((lambda s, t: tsw._solve_K_windowed(s, t, bounds)) if par
                 else tsw._solve_K)
        ref = tsw._admm_iterations(*carries, sweep=plain)
        held(f"a tree of S={S}, N={N}, b={sw.b} ({sw.n_ext} extra row), "
             f"{K6_TREE_ITERS} it through the route "
             f"({'parallel, ' + str(C) + ' windows' if par else 'sequential'}"
             f"; launches {launched})", regime,
             {k: (g, r) for k, g, r in zip(K5_FIELDS, got, ref)
              if g is not None})
        check(launched == {kernel: K6_TREE_ITERS},
              f"a tree of S={S}: the route launched {launched}, not "
              f"{kernel} once an iteration")
        if par:
            k5_err_into(rec, got, ref)


# K5's holds: a whole relaxation (config 6's 150 iterations) cold and warm
# at ρ, and a probe of 200 iterations at ρ·10 on rounded boxes, warm from
# the relaxation, at every driven shape; each timed (kernel alone, wrapper,
# plain loop) warm at ρ, and config 6's probe too
K5_RELAX, K5_PROBE = CFG6_SPEC["qp_iters"], 200


# the soft state box of phase 22's last hold: the double integrator's
# |x| ≤ 10 rows (6-9 of its 10 stage rows) soft at every stage, from a state
# outside the box, so that the penalty prox binds (on no driven path does a
# soft row leave its bound)
SOFT_BOX_ROWS = (6, 7, 8, 9)
SOFT_BOX_N = 10
# the shapes where phase 22 also forces K5's unstaged variant (the factors
# read through L2, as shapes whose factors do not fit shared memory run)
K5_UNSTAGED = ("cfg6", "hull", "di_two_forces")
# the limits of the shapes off the "k5" regime (LIMITS has why)
K5_REGIMES = dict(hull="k5_wide", di_two_forces="k5_wide",
                  soft_box="k5_soft", serve_oob="k5_infeasible")


def di_two_forces():
    """The switched double integrator with a second, unswitched force u₂
    on the velocity (|u₂| ≤ 1, weight 0.1): b = 6. No model of the repo
    has a stagewise block of 1-4 or 6-8, so K5's generic bmax-8
    instantiation is held on this one."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.mld.info import MldInfo
    from pyhybridcontrol_tpu_torch.mld.model import MldModel
    from pyhybridcontrol_tpu_torch.models import switched_double_integrator

    m = switched_double_integrator().numpy_mats()
    nc = m.E.shape[0]
    two = np.zeros((2, 1))
    mats = {k: m[k] for k in ("A", "B2", "B3", "b5", "C", "D2", "D3", "d5")}
    mats.update(B1=np.hstack([m.B1, [[0.0], [0.25]]]),
                D1=np.hstack([m.D1, np.zeros((2, 1))]),
                E=np.vstack([m.E, np.zeros((2, 2))]),
                F1=np.block([[m.F1, np.zeros((nc, 1))],
                             [np.zeros((2, 1)), np.array([[1.0], [-1.0]])]]),
                F2=np.vstack([m.F2, two]), F3=np.vstack([m.F3, two]),
                f5=np.vstack([m.f5, [[1.0], [1.0]]]))
    info = MldInfo(nx=2, nu=2, ndelta=1, nz=1, nomega=0, ny=2,
                   ncons=nc + 2)
    return MldModel.from_matrices(info, **mats)


def k5_waves(dev, rng):
    """(tag, key, backend, its ρ·10 twin, f, h, lb, ub) of a wave of nodes
    at every driven stagewise shape: config 6's long arm (8 nodes × S=8,
    the budget row) and parity arm (32 × S=2), the served double
    integrator (N=10, a wave of 32; also from OUT_OF_BOX, where every node
    is infeasible and certified so) and the transforms hold (soft rows,
    blocking, terminal set, budget row; N=8, a wave of 16); and the
    double integrator with its state box soft at every stage from
    OUT_OF_BOX (N=10, a wave of 16), where the soft rows' prox binds; the
    wider blocks K5 is built for, which no driven path reaches yet: the
    PWA hull model as ``serve --config pwa_actuator --solver stagewise``
    builds it (N=20, b=13: bmax 16; a wave of 64) and ``di_two_forces``
    (N=10, b=6: bmax 8 without b=5's instantiation; a wave of 16);
    K4_HOLD_FIX of the branching coordinates fixed at random."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch import serve
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.models import (
        di_default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.ops.condense import MpcWeights
    from pyhybridcontrol_tpu_torch.ops.stagewise import (
        assemble_stagewise, assemble_stagewise_ext, prepare_stagewise)
    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        assemble_stagewise_tree_ext)
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec
    from pyhybridcontrol_tpu_torch.solver.bnb_stagewise import (
        StagewiseBackend, pack_stagewise_data)

    tree_s, tree_l = config6_trees()
    x0 = torch.tensor(X0_6, device=dev)
    out = []
    for tag, key, tree, extra, W in (
            ("config 6 long arm", "cfg6", tree_l, config6_extra(CFG6_N),
             CFG6_SPEC["wave_size"]),
            ("config 6 parity arm", "cfg6_parity", tree_s, None,
             CFG6_PARITY_SPEC["wave_size"])):
        swt, swtp = config6_preps(dev, tree, extra)
        eu = None if extra is None else assemble_stagewise_tree_ext(swt, x0)
        be, *wave = node_wave(swt, eu, rng, W, K4_HOLD_FIX)
        out.append((tag, key, be, type(be)(swtp, ext_u=eu), *wave))
    two = MpcController(di_two_forces(), 10, MpcWeights(
        Qx=np.array([1.0, 0.1]), QxN=np.array([5.0, 0.5]),
        Ru=np.array([0.1, 0.1]), qdelta=np.array([0.05])),
        solver="stagewise", bnb_spec=BnbSpec(wave_size=16),
        device=dev.type).build()
    for tag, key, c, x in (
            ("served double integrator", "serve_sw", serve.make_controller(
                "double_integrator", "stagewise", dev.type), (2.0, 0.0)),
            ("served double integrator from out of the box", "serve_oob",
             serve.make_controller("double_integrator", "stagewise",
                                   dev.type), OUT_OF_BOX),
            ("transforms hold", "transforms", sw_transforms_controller(dev),
             (1.0, -0.5)),
            ("PWA hull, served stagewise", "hull", serve.make_controller(
                "pwa_actuator", "stagewise", dev.type), (1.0, 0.0)),
            ("double integrator with a second force", "di_two_forces", two,
             (2.0, 0.0))):
        xt = torch.tensor(x, device=dev)
        eu = assemble_stagewise_ext(c._sw, xt) if c._sw.n_ext else None
        be = StagewiseBackend(c._sw, ext_u=eu)
        f, h = pack_stagewise_data(*assemble_stagewise(c._sw, xt))
        out.append((tag, key, be, StagewiseBackend(c._sw_probe, ext_u=eu),
                    *wave_boxes(be, f, h, c.bnb_spec.wave_size, rng,
                                K4_HOLD_FIX)))
    model = switched_double_integrator()
    nc = model.info.ncons
    rows = np.array([k * nc + r for k in range(SOFT_BOX_N)
                     for r in SOFT_BOX_ROWS])
    sw, swp = (prepare_stagewise(model, SOFT_BOX_N, di_default_weights(),
                                 rho=rho, soft=(rows, 5.0, 1.0), device=dev)
               for rho in (1.0, 10.0))
    be = StagewiseBackend(sw)
    f, h = pack_stagewise_data(*assemble_stagewise(
        sw, torch.tensor(OUT_OF_BOX, device=dev)))
    out.append(("soft state box, every stage, from out of the box",
                "soft_box", be, StagewiseBackend(swp),
                *wave_boxes(be, f, h, 16, rng, K4_HOLD_FIX)))
    return out


def k5_work(args):
    """(bytes, {type: operations}) of one K5 call on ``args`` (those of
    ``sw_admm_cuda``): per problem q, x, l, u, z, y (and z_e, y_e, u_e)
    read once, x, z, y, dy (and z_e, y_e, dy_e) written once, the
    constants once; per problem, stage and iteration the sweep (6·b² + 2·b
    as ``k4_work``), A and Aᵀ with J and M dense (8·m·b), ~10 operations
    a row's update, and the Woodbury term (4·n_ext·b)."""
    sw, q, iters, M = args[0], args[1], args[10], args[11]
    N, b, m, r = sw.N, sw.b, sw.m_k, sw.n_ext
    P = q.numel() // (N * b)
    mean = M is not None and sw.n_cons > 0
    per_problem = 3 * N * b + 7 * N * m + 6 * r
    consts = (3 * N * b * b + 2 * m * b + N * sw.n_blk + 3 * m * N
              + 2 * r * N * b + r * r + r + (M.numel() if mean else 0))
    ops = P * iters * N * (6 * b * b + 2 * b + 8 * m * b + 10 * m + 4 * r * b)
    return 4 * (P * per_problem + consts), dict(fp32=ops)


def phase_k5(dev, rng, rec):
    """K5 against its plain version (``_admm_iterations``: the torch loop
    with the plain sweeps, on the card) at every shape of ``k5_waves``, at
    ρ and ρ·10: the carries x, z, y, dy (and the extra rows' z_e, y_e,
    dy_e) of the very calls a B&B wave makes — the relaxation cold and
    warm, the probe warm on rounded boxes — within the limits of their
    regime (K5_REGIMES, else "k5"); at the shapes of K5_UNSTAGED also with
    the unstaged variant forced. The certificate bits of each solve equal
    those the solve gives from the plain loop's carries, but near a
    threshold (``k5_cert_near``). Times of K5 alone, of its wrapper and of
    the plain loop, its roofline bound and its chain floor (iterations ×
    ``k4_chain_ms``)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    print("K5 (stagewise ADMM loop) vs the plain loop:", flush=True)
    names = ("x", "z", "y", "dy", "z_e", "y_e", "dy_e")
    for tag, key, be, bp, fb, hb, lb, ub in k5_waves(dev, rng):
        with k5_calls() as calls:
            r0 = be.solve(fb, hb, lb, ub, K5_RELAX)
            warm = (r0.x, r0.z, r0.y)
            reps = torch.as_tensor(be.binary_idx, device=dev)
            pv = torch.round(torch.clamp(r0.x[:, reps], 0.0, 1.0))
            lbp, ubp = lb.clone(), ub.clone()
            lbp[:, reps] = ubp[:, reps] = pv
            runs = (lambda: be.solve(fb, hb, lb, ub, K5_RELAX),
                    lambda: be.solve(fb, hb, lb, ub, K5_RELAX, warm=warm),
                    lambda: bp.solve(fb, hb, lbp, ubp, K5_PROBE, warm=warm))
            results = [r0, runs[1](), runs[2]()]
        check(len(calls) == 3, f"{tag}: {len(calls)} K5 calls for 3 solves")
        for kind, args, run, res in zip(
                ("relaxation cold", "relaxation warm", "probe at ρ·10 warm"),
                calls, runs, results):
            sw, M = args[0], args[11]
            P = args[1].numel() // (sw.N * sw.b)
            mean = M is not None and sw.n_cons > 0
            S = M.shape[0] if mean else 1
            ref = tsw._admm_iterations(*args)
            with k5_replayed(ref):
                ref_res = run()
            what = (f"{tag} {kind}, P={P} N={sw.N} b={sw.b} m={sw.m_k} S={S} "
                    f"({args[10]} it, certs={int(res.infeas_cert.sum())}")
            certs_held(what + ")", res, ref_res,
                       lambda: k5_cert_near(args, ref,
                                            res.infeas_cert.shape))
            pl = cs.plan_admm(P, sw.N, sw.b, sw.m_k, S, sw.n_blk, sw.n_ext,
                              sw.n_cons, mean)
            for staged in (None, False) if (
                    key in K5_UNSTAGED and pl.staged) else (None,):
                pl = cs.plan_admm(P, sw.N, sw.b, sw.m_k, S, sw.n_blk,
                                  sw.n_ext, sw.n_cons, mean, staged)
                got = cs.sw_admm_cuda(*args, staged=staged)
                held(f"{what}; bmax {pl.bmax}, "
                     f"{'staged' if pl.staged else 'factors through L2'}, "
                     f"{32 * pl.warps} threads a CTA, clusters of "
                     f"{pl.cluster})", K5_REGIMES.get(key, "k5"),
                     {k: (g, r) for k, g, r in zip(names, got, ref)
                      if g is not None})
                rec["max_abs_err"] = max(
                    [rec.get("max_abs_err", 0.0)]
                    + [float((g - r).abs().max()) for g, r in zip(got, ref)
                       if g is not None])
        if not TIMINGS:
            continue
        for pre, args in ((("" if key == "cfg6" else key + "_"), calls[1]),
                          *((("cfg6_probe_", calls[2]),) if key == "cfg6"
                            else ())):
            sw = args[0]
            by = timed(rec, pre, lambda: cs.sw_admm_cuda(*args),
                       lambda: tsw._admm_iterations(*args), k5_work(args))
            rec[pre + "chain_ms"] = args[10] * k4_chain_ms(sw.N, sw.b)
            if not pre:
                rec["bound_by"] = by
                rec["library_ms"] = None   # no PyTorch call runs an ADMM loop
            print(f"  chain floor {rec[pre + 'chain_ms']:.3f} ms ({args[10]} "
                  f"iterations of {2 * sw.N} sweep stages)", flush=True)


def wall_median(fn, reps=3):
    """Median host-clock seconds of ``reps`` calls of ``fn``, each ended by
    a synchronise (the caller warms ``fn`` first)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2]


def plan6_feasible(tag, model, tree, x0, xi, budget=None, tol=FEAS_TOL):
    """A stagewise tree plan xi (S, N, b) in fp64: each scenario's dynamics
    on its own path, its stage rows and box, binaries in {0, 1}, u and δ
    equal across the scenarios of an information set, and (with
    ``budget``) Σ_k u_k ≤ budget on every path; within ``tol``."""
    import numpy as np

    m = model.numpy_mats()
    info = model.info
    nv = info.nv
    Bv = np.hstack([m.B1, m.B2, m.B3])
    Fv = np.hstack([m.F1, m.F2, m.F3])
    xi = np.asarray(xi, np.float64)
    om = np.asarray(tree.omega_paths, np.float64)
    worst = 0.0
    for s in range(tree.S):
        x = np.asarray(x0, np.float64)
        for k in range(tree.N):
            v, xn = xi[s, k, :nv], xi[s, k, nv:]
            dyn = xn - (m.A @ x + Bv @ v + m.b5[:, 0] + m.B4 @ om[s, k])
            ineq = m.E @ x + Fv @ v - (m.f5[:, 0] - m.F4 @ om[s, k])
            worst = max(worst, np.abs(dyn).max(), ineq.max())
            x = xn
    vb = xi[:, :, :nv][:, :, info.v_binary_mask]
    bin_err = np.abs(vb - np.round(vb)).max()
    box_err = max(np.max(-vb), np.max(vb - 1.0), 0.0)
    g = np.asarray(tree.groups)
    nud = info.nu + info.ndelta
    na = max(np.ptp(xi[g[:, k] == gid, k, :nud], axis=0).max()
             for k in range(tree.N) for gid in np.unique(g[:, k]))
    over = (xi[:, :, 0].sum(axis=1).max() - budget) if budget else -np.inf
    print(f"  {tag}: dynamics/stage rows {worst:.2e}, binaries {bin_err:.2e}"
          f", box {box_err:.2e}, non-anticipativity {na:.2e}"
          + (f", budget Σu - {budget:g} = {over:.2e}" if budget else "")
          + f" (limit {tol:g})", flush=True)
    check(max(worst, bin_err, box_err, na, over) <= tol,
          f"{tag}: the plan is not feasible in fp64")


def stagewise_value(sw, q, model, x0, V):
    """The stagewise objective ½ξᵀPξ + qᵀξ (fp64) of a plan V (N, nv): its
    states simulated from x0, ξ_k = [v_k; x_{k+1}]."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    m = model.numpy_mats()
    Bv = np.hstack([m.B1, m.B2, m.B3])
    x, xs = np.asarray(x0, np.float64), []
    for k in range(sw.N):
        x = m.A @ x + Bv @ V[k] + m.b5[:, 0]
        xs.append(x)
    xi = torch.as_tensor(np.concatenate([V, np.array(xs)], axis=1),
                         device=sw.device)
    sw64 = tsw.stagewise_double(sw)
    return float(0.5 * (xi * tsw._apply_P(sw64, xi)).sum()
                 + (q.double() * xi).sum())


def only_k5(path, multiple, solves, kernel="stagewise_k5"):
    """Every launch on ``path`` was K5's in the variant ``kernel`` (the
    shared one by default), one a relaxation or probe (of ``solves``), each
    at a P that is a multiple of ``multiple``."""
    got = PATH_LAUNCHES[path]
    check(got[kernel] == solves > 0 and all(
        v == 0 for k, v in got.items() if k != kernel),
        f"{path}: K5 ({kernel}) once a relaxation or probe ({solves}) and "
        f"nothing else must launch, launches {got}")
    sizes = PATH_BATCHES[path][kernel]
    check(all(P % multiple == 0 for P in sizes),
          f"{path}: K5 launched at P = {sorted(sizes)}, not multiples of "
          f"{multiple}")


def profile_wave(swt, eu):
    """One relaxation of a long-arm wave (8 nodes × S=8, 150 iterations:
    the solve is ~46 of these, relaxations and probes alike) under
    torch.profiler: device operations, K5's launch and device time, busy
    time, and the idle share against the same call unprofiled (median of
    3 on the host clock)."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.profile_serve import profile_request

    be, fb, hb, lb, ub = node_wave(swt, eu, np.random.default_rng(SEED),
                                   CFG6_SPEC["wave_size"], K4_HOLD_FIX)

    def run():
        return be.solve(fb, hb, lb, ub, CFG6_SPEC["qp_iters"])

    run()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    prof = profile_request(run)
    prof["ms"] = sorted(times)[1]
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / prof["ms"]
    print(f"  one wave's relaxation ({CFG6_SPEC['qp_iters']} it, P="
          f"{CFG6_SPEC['wave_size'] * CFG6_S}) under torch.profiler: "
          f"{prof['device_ops']} device operations, busy "
          f"{prof['device_busy_ms']:.2f} ms of {prof['ms']:.2f} ms "
          f"unprofiled (idle share {prof['idle_share']:.3f}); K5 "
          f"{prof['k5_launches']} launch, {prof['k5_device_ms']:.2f} ms "
          "on the device", flush=True)
    check(prof["k5_launches"] == 1 and prof["k4_launches"] == 0,
          f"config 6 profile: {prof['k5_launches']} K5 and "
          f"{prof['k4_launches']} K4 kernels on the device for one "
          "relaxation")
    return prof


def config6_parallel_twin(model, tree_l, swt, swtp, data, eu, res):
    """Config 6's long arm with ``parallel_sweeps=True`` (the path
    config6_long_par): every relaxation and probe one launch of K5's
    parallel sweep in the shared variant, at a multiple of S; found as the
    sequential solve ``res``, its objective within 1e-3 of that solve's and
    of the JAX package's (CFG6_REF_OBJ_PAR, with the log-depth sweeps), its
    plan feasible in fp64; then read again warm (``long_warm_reading``)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        solve_tree_miqp_stagewise)
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    spec = BnbSpec(**CFG6_SPEC)

    def solve():
        return solve_tree_miqp_stagewise(swt, *data, spec, swt_probe=swtp,
                                         ext_u=eu, parallel_sweeps=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with solve_calls() as n, k5_calls() as calls:
        r, _ = drive("config6_long_par", solve)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    only_k5("config6_long_par", CFG6_S, n[0], kernel="stagewise_k5_par")
    check(all(kw.get("parallel") for kw in calls.kw) and calls,
          "config 6 long arm twin: a K5 call without the parallel sweep")
    obj, seq = float(r.obj), float(res.obj)
    rel = abs(obj - seq) / max(1.0, abs(seq))
    rel_ref = abs(obj - CFG6_REF_OBJ_PAR) / max(1.0, abs(CFG6_REF_OBJ_PAR))
    pl = k5_plan_of(calls[0], parallel=True)[1]
    print(f"config 6 long arm, the parallel_sweeps twin ({pl.windows} "
          f"windows a problem, {describe_plan(pl)}): {sec:.3f} s, found "
          f"{bool(r.found)}, {int(r.nodes_solved)} nodes, {r.waves} waves, "
          f"{len(calls)} K5 launches; objective {obj:.7f} against the "
          f"sequential solve's {seq:.7f} (relative {rel:.2e}) and the JAX "
          f"package's with parallel_sweeps {CFG6_REF_OBJ_PAR:.7f} (relative "
          f"{rel_ref:.2e}; limit 1e-3 each)", flush=True)
    check(bool(r.found) == bool(res.found) and rel <= 1e-3
          and rel_ref <= 1e-3,
          "config 6 long arm twin: off the sequential solve or the JAX "
          "package's")
    plan6_feasible("config 6 long arm twin plan", model, tree_l, X0_6,
                   r.x.reshape(CFG6_S, CFG6_N, swt.sw.b).cpu(),
                   budget=CFG6_BUDGET)
    return dict(s=sec, found=bool(r.found), obj=obj, seq_obj=seq,
                ref_obj=CFG6_REF_OBJ_PAR, nodes=int(r.nodes_solved),
                waves=r.waves, windows=pl.windows, k5_launches=len(calls),
                profile=long_warm_reading("the parallel_sweeps twin", solve,
                                          path="config6_long_par"))


def phase_config6(dev):
    """Config 6 of the reference bench (bench.py:742-816) through the port,
    nothing cut, with the plain sweeps made to raise: the parity arm
    (S=2, N=4) within 1e-3 of the port's fp64 oracle on the dense joint
    frame; the long arm (S=8, N=120, Σu ≤ 60) one warm-up and the median
    of 3, its objective within 1e-3 of the JAX package's, its plan
    feasible in fp64, one K5 launch a relaxation or probe, each at a
    multiple of S=8; and
    ``serve --config double_integrator --solver stagewise`` through the
    stdin loop, its objectives within ``serve_limit`` of the port's
    condensed enumeration plan valued in the stagewise frame; the
    stagewise controller with every stage-row transform and a budget row,
    the card against the CPU."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch import serve
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.models import di_default_weights
    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
    from pyhybridcontrol_tpu_torch.ops.scenario_tree import (
        build_scenario_tree_qp)
    from pyhybridcontrol_tpu_torch.ops.stagewise import assemble_stagewise
    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        assemble_stagewise_tree, assemble_stagewise_tree_ext,
        solve_tree_miqp_stagewise)
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    model, w = omega_model(), di_default_weights()
    tree_s, tree_l = config6_trees()
    x0 = torch.tensor(X0_6, device=dev)
    out = {}
    with no_plain_sweep():
        # (a) parity arm
        swt, swtp = config6_preps(dev, tree_s)
        data = assemble_stagewise_tree(swt, x0)
        t0 = time.perf_counter()
        with solve_calls() as n_par:
            rs, _ = drive("config6_parity", lambda: solve_tree_miqp_stagewise(
                swt, *data, BnbSpec(**CFG6_PARITY_SPEC), swt_probe=swtp))
        ms_par = 1e3 * (time.perf_counter() - t0)
        only_k5("config6_parity", tree_s.S, n_par[0])
        joint = build_scenario_tree_qp(CondensedMpc(model, 4, w), tree_s)
        fo, ho = joint.assemble_np(np.asarray(X0_6),
                                   tree_s.omega_paths.reshape(8, 1))
        orc, onodes = oracle_bnb(joint, fo, ho)
        V = (rs.x.reshape(2, 4, swt.sw.b)[:, :, :swt.sw.nv].reshape(-1)
             .double().cpu().numpy())
        dev_obj = float(0.5 * V @ joint.H @ V + fo @ V)
        rel = abs(dev_obj - orc) / max(1.0, abs(orc))
        print(f"config 6 parity arm (S=2, N=4): {ms_par:.0f} ms, found "
              f"{bool(rs.found)}, {int(rs.nodes_solved)} nodes, {rs.waves} "
              f"waves; plan on the joint frame {dev_obj:.6f}, fp64 oracle "
              f"{orc:.6f} ({onodes} nodes), relative {rel:.2e} (limit 1e-3)",
              flush=True)
        check(bool(rs.found) and rel <= 1e-3,
              f"config 6 parity arm: {rel:.3e} off the fp64 oracle")
        out["parity"] = dict(ms=ms_par, device_obj=dev_obj, oracle_obj=orc,
                             rel_delta=rel)

        # (b) long arm
        swt, swtp = config6_preps(dev, tree_l, config6_extra(CFG6_N))
        data = assemble_stagewise_tree(swt, x0)
        eu = assemble_stagewise_tree_ext(swt, x0)
        spec = BnbSpec(**CFG6_SPEC)

        def solve():
            return solve_tree_miqp_stagewise(swt, *data, spec,
                                             swt_probe=swtp, ext_u=eu)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with solve_calls() as n_long:
            res, _ = drive("config6_long", solve)
        warm_s = time.perf_counter() - t0
        only_k5("config6_long", CFG6_S, n_long[0])
        k5 = PATH_LAUNCHES["config6_long"]["stagewise_k5"]
        times = []
        for _ in range(CFG6_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = solve()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(float(r.obj) == float(res.obj), "config 6: repetitions "
                  "ended on different plans")
        ms = 1e3 * sorted(times)[len(times) // 2]
        obj = float(res.obj)
        rel = abs(obj - CFG6_REF_OBJ) / max(1.0, abs(CFG6_REF_OBJ))
        print(f"config 6 long arm (S={CFG6_S}, N={CFG6_N}, one coupled row): "
              f"warm-up {warm_s:.3f} s, {[round(t, 3) for t in times]} s, "
              f"median {ms:.1f} ms a solve; found {bool(res.found)}, "
              f"{int(res.nodes_solved)} nodes, {res.waves} waves, {k5} K5 "
              f"launches (P={sorted(PATH_BATCHES['config6_long']['stagewise_k5'])}"
              f"); objective {obj:.7f}, the JAX package's {CFG6_REF_OBJ:.7f}, "
              f"relative {rel:.2e} (limit 1e-3)", flush=True)
        check(bool(res.found) and rel <= 1e-3,
              f"config 6 long arm: objective {obj} off the reference's")
        plan6_feasible("config 6 long arm plan", model, tree_l, X0_6,
                       res.x.reshape(CFG6_S, CFG6_N, swt.sw.b).cpu(),
                       budget=CFG6_BUDGET)
        prof = profile_wave(swt, eu)
        out["long"] = dict(N=CFG6_N, S=CFG6_S, n_ext=1, ms_per_solve=ms,
                           seconds=times, nodes=int(res.nodes_solved),
                           waves=res.waves, found=bool(res.found),
                           objective=obj, k5_launches=k5, profile=prof)
        out["long_parallel"] = config6_parallel_twin(
            model, tree_l, swt, swtp, data, eu, res)

        # (c) the single-instance path: serve --solver stagewise
        print("serve --config double_integrator --solver stagewise:",
              flush=True)
        t0 = time.perf_counter()
        ctrl, ready = serve.build_controller("double_integrator",
                                             "stagewise", dev.type)
        print(f"  controller built + warmup solve: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        lines = ['{"cmd": "ping"}']
        lines += [json.dumps({"x": x}) for x in SERVE_SW_STATES]
        lines += [json.dumps({"x": OUT_OF_BOX}), '{"cmd": "quit"}']
        buf = io.StringIO()
        with solve_calls() as n_serve:
            drive("serve_stagewise", lambda: serve.stdin_loop(
                ctrl, ready, inp=io.StringIO("\n".join(lines) + "\n"),
                out=buf))
    only_k5("serve_stagewise", 1, n_serve[0])
    replies = [json.loads(s) for s in buf.getvalue().splitlines()]
    check(replies[1] == {"pong": True}, "serve stagewise: ping not answered")
    check(len(replies) == 2 + len(SERVE_SW_STATES) + 1,
          "serve stagewise: missing replies")
    enum = MpcController(ctrl.model, ctrl.N, ctrl.weights,
                         solver="enumerate", qp_iters=600, device=dev)
    diffs, refs = [], []
    for x, r in zip(SERVE_SW_STATES, replies[2:]):
        check("error" not in r and r["found"],
              f"serve stagewise: x0={x} not solved: {r}")
        ref = enum.feedback(x)
        xt = torch.tensor(x, device=dev)
        q = assemble_stagewise(ctrl.stagewise, xt)[0]
        val = stagewise_value(ctrl.stagewise, q, ctrl.model, x,
                              ref.v_seq.double().cpu().numpy())
        d = abs(r["obj"] - val)
        print(f"  x0={x}: obj={r['obj']:.6f}, the enumeration's plan in the "
              f"stagewise frame {val:.6f} |Δ|={d:.2e} ms={r['ms']}",
              flush=True)
        diffs.append(d)
        refs.append(val)
    serve_reading("serve stagewise vs enumeration", diffs, refs)
    bad = replies[-1]
    check("error" not in bad and bad["found"] is False,
          f"serve stagewise: out-of-box state must come back found=false, "
          f"got {bad}")
    out["serve_ms"] = [r["ms"] for r in replies[2:]]

    # (d) soft rows, move blocking, a terminal set and an input budget at
    # once through the stagewise controller: the card against the CPU
    prices = np.zeros((8, 3), np.float32)
    prices[:, 0] = 0.1
    kw = dict(price_seq=prices, u_prev=np.array([0.2], np.float32))

    def transforms(device):
        return sw_transforms_controller(device).feedback([1.0, -0.5], **kw)

    t0 = time.perf_counter()
    with no_plain_sweep(), solve_calls() as n_tr:
        got, _ = drive("stagewise_transforms", lambda: transforms(dev))
    ms = 1e3 * (time.perf_counter() - t0)
    only_k5("stagewise_transforms", 1, n_tr[0])
    ref = transforms("cpu")
    rel = abs(float(got.obj) - float(ref.obj)) / max(1.0, abs(float(ref.obj)))
    du = float((got.u.cpu() - ref.u).abs().max())
    print(f"stagewise controller, soft rows + blocking + terminal set + "
          f"budget row (N=8): card {float(got.obj):.6f} in {ms:.0f} ms, "
          f"CPU {float(ref.obj):.6f}, relative {rel:.2e} (limit 1e-3), "
          f"|Δu| {du:.2e} (3e-2)", flush=True)
    check(bool(got.found) and bool(ref.found) and rel <= 1e-3 and du <= 3e-2,
          "stagewise transforms: the card's solve is off the CPU's")
    out["transforms"] = dict(ms=ms, obj=float(got.obj), cpu_obj=float(ref.obj))
    return out


# ---- K5 at every stagewise shape: the grouped and global-state variants
# (phases 35-36, paths long_horizon and wide_tree) -------------------------

# K5's variants by the name each launch counts under (cuda_stagewise's
# ADMM_LAUNCH): the shared one of config 6's paths, then the FLEX ones
K5_FAMILY = ("stagewise_k5", "stagewise_k5_grouped", "stagewise_k5_global",
             "stagewise_k5_global_all", "stagewise_k5_horizon")
# long_horizon: the double integrator at N=1000 (N·nv = 3000, past the
# reference's "N·nv in the thousands") and the PWA hull model at N=300, each
# one stagewise feedback from X0_LONG with a bounded search
LONG_DI_N, LONG_HULL_N = 1000, 300
X0_LONG = {"di": (2.0, 0.0), "hull": (1.0, 0.0)}
LONG_SPEC = dict(capacity=64, wave_size=8, max_waves=8, qp_iters=300,
                 probe_iters=1000)
# the JAX package's objectives on the same controllers on the CPU (readings
# printed beside the port's; None: it finds no plan, 47 nodes at the hull
# model; JAX_PLATFORMS=cpu python tools/long_reference.py [--parallel])
LONG_REF_OBJ = {"di": 5.313244342803955, "hull": None}
LONG_REF_OBJ_PAR = {"di": 5.313243865966797, "hull": None}
# wide_tree: config 6's long arm (N=120, Σu ≤ 60, tree-consistent paths of
# sd 0.2) with more scenarios: (S, branch steps); 27 = 3³ leaves a group
# that does not divide over the CTAs; waves capped as the split trees were
WIDE_TREES = ((16, (1, 30, 60, 90)), (27, (1, 40, 80)),
              (64, (1, 20, 40, 60, 80, 100)))
# the variant K5's plan takes at each wide tree: portable clusters of
# ⌈S/8⌉ scenarios a CTA, the state in shared memory where those slots fit
# it, else z, y, l and u in device memory (S=64)
WIDE_VARIANT = {16: "stagewise_k5_grouped", 27: "stagewise_k5_grouped",
                64: "stagewise_k5_global"}
WIDE_SPEC = dict(CFG6_SPEC, max_waves=4)
U0_SPREAD = 5e-3          # u₀ over the scenarios (tests/test_stagewise_tree.py)
# the kernel against its plain version: 20 iterations from the kernel's
# own relaxation (the plain loop on the card costs ~10 ms an iteration at
# N=120), timed at the whole relaxation's count too
FLEX_HOLD_ITERS = 20


def wide_tree(S, steps):
    """Config 6's tree with S scenarios branching at ``steps`` (factor
    S^(1/len(steps))), tree-consistent paths of sd 0.2 from
    default_rng(S)."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.ops.scenario_tree import (
        ScenarioTree, tree_consistent_paths)

    rng = np.random.default_rng(S)
    return ScenarioTree.from_branching(
        tree_consistent_paths(rng, S, CFG6_N, steps, sd=0.2),
        branch_steps=steps)


def long_controller(key, dev, parallel=False):
    """The stagewise controller of a long_horizon solve: the double
    integrator at LONG_DI_N or the PWA hull model (on/off actuator, as
    config 2) at LONG_HULL_N, with LONG_SPEC; ``parallel``: its
    ``sw_parallel`` twin (the horizon-parallel sweeps)."""
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.models import (
        di_default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.models.pwa_examples import (
        pwa_spring_mld, pwa_weights)
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    if key == "di":
        model, N, w = switched_double_integrator(), LONG_DI_N, \
            di_default_weights()
    else:
        model, N, w = pwa_spring_mld(on_off=True, formulation="hull"), \
            LONG_HULL_N, pwa_weights()
    return MpcController(model, N, w, solver="stagewise",
                         bnb_spec=BnbSpec(**LONG_SPEC), sw_parallel=parallel,
                         device=dev).build()


def flex_waves(dev, rng):
    """(tag, key, backend, f, h, lb, ub, variant) of a wave of nodes at
    each shape the FLEX and horizon variants run on a path: the
    long_horizon controllers' frames (LONG_SPEC's wave; the horizon
    variant) and the wide trees' (WIDE_SPEC's wave × S; WIDE_VARIANT),
    K4_HOLD_FIX of the branching coordinates fixed at random; ``variant``
    the one the plan picks."""
    import torch

    from pyhybridcontrol_tpu_torch.ops.stagewise import (
        assemble_stagewise, assemble_stagewise_ext)
    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        assemble_stagewise_tree_ext)
    from pyhybridcontrol_tpu_torch.solver.bnb_stagewise import (
        StagewiseBackend, pack_stagewise_data)

    out = []
    for key in ("di", "hull"):
        c = long_controller(key, dev)
        xt = torch.tensor(X0_LONG[key], device=dev)
        eu = assemble_stagewise_ext(c._sw, xt) if c._sw.n_ext else None
        be = StagewiseBackend(c._sw, ext_u=eu)
        f, h = pack_stagewise_data(*assemble_stagewise(c._sw, xt))
        out.append((f"{key} N={c._sw.N}", key, be,
                    *wave_boxes(be, f, h, LONG_SPEC["wave_size"], rng,
                                K4_HOLD_FIX), "stagewise_k5_horizon"))
    x0 = torch.tensor(X0_6, device=dev)
    for S, steps in WIDE_TREES:
        swt = config6_preps(dev, wide_tree(S, steps), config6_extra(CFG6_N))[0]
        eu = assemble_stagewise_tree_ext(swt, x0)
        out.append((f"config 6's tree at S={S}", f"tree{S}",
                    *node_wave(swt, eu, rng, WIDE_SPEC["wave_size"],
                               K4_HOLD_FIX), WIDE_VARIANT[S]))
    return out


K5_FIELDS = ("x", "z", "y", "dy", "z_e", "y_e", "dy_e")


def k5_plan_of(args, variant=None, runtime_r=None, parallel=False,
               spc=None):
    """(P, the plan) of a K5 call on ``args`` (those of ``sw_admm_cuda``),
    ``variant``, ``runtime_r``, ``parallel`` and ``spc`` as the
    wrapper's (with a group mean, its member lists' words)."""
    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs

    sw, M = args[0], args[11]
    P = args[1].numel() // (sw.N * sw.b)
    mean = M is not None and sw.n_cons > 0
    members = cs.admm_members(sw, M.float().contiguous()).numel() \
        if mean else 0
    return P, cs.plan_admm(P, sw.N, sw.b, sw.m_k, M.shape[0] if mean else 1,
                           sw.n_blk, sw.n_ext, sw.n_cons, mean,
                           variant=variant, runtime_r=runtime_r,
                           parallel=parallel, device=args[1].device,
                           members=members, spc=spc)


def k5_err_into(rec, got, ref):
    """The record's max_abs_err raised to the largest |got − ref|."""
    rec["max_abs_err"] = max(
        [rec.get("max_abs_err", 0.0)]
        + [float((g - r).abs().max()) for g, r in zip(got, ref)
           if g is not None])


def with_warm(args, out, iters):
    """``sw_admm_cuda``'s arguments ``args`` warm from the carries ``out``
    (those it returned), for ``iters`` iterations."""
    a = list(args)
    a[4:9] = (out[0], out[1], out[2], out[4], out[5])
    a[10] = iters
    return tuple(a)


def horizon_holds(tag, key, args, out, held_args, pl, rec):
    """At a long_horizon wave (``args`` its relaxation, ``out`` the horizon
    variant's result of it, ``held_args`` FLEX_HOLD_ITERS iterations more
    from it): the sequential sweep bitwise the global variant's forced at
    the same lanes a stage, on every carry of both calls; the parallel
    sweep against its plain version (``_admm_iterations`` with
    ``_solve_K_windowed`` on the plan's windows) within "k5_horizon_par"
    ("k5_horizon_par_wide" at b=13); the window maps' largest norms.
    Times (TIMINGS) of the parallel sweep alone (held iterations and the
    relaxation), its wrapper, its plain version (one run), the bound and
    the chain floor, into ``rec`` under "par_" ("hull_par_")."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    sw = args[0]
    P = args[1].numel() // (sw.N * sw.b)
    for a, what in ((args, f"the relaxation ({K5_RELAX} it)"),
                    (held_args, f"{FLEX_HOLD_ITERS} it warm from it")):
        want = cs.sw_admm_cuda(*a, variant="global", tps=pl.tps)
        got = out if a is args else cs.sw_admm_cuda(*a)
        same = [k for k, g, w in zip(K5_FIELDS, got, want)
                if g is not None and torch.equal(g, w)]
        print(f"  {tag}, P={P}, {what}: the horizon variant's sequential "
              f"sweep (C={pl.cluster}, {pl.tps} lanes a stage) bitwise the "
              f"global variant's at {pl.tps} lanes on {same}", flush=True)
        check(len(same) == sum(g is not None for g in got),
              f"{tag}: the horizon variant's sequential sweep differs from "
              f"the global variant's")
        BITWISE[0] += 1
    win = cs.horizon_windows(sw.N, pl.cluster)

    def plain():
        return tsw._admm_iterations(
            *held_args, sweep=lambda s, t: tsw._solve_K_windowed(s, t, win))

    def wrapper():
        return cs.sw_admm_cuda(*held_args, parallel=True)

    got, ref = wrapper(), plain()
    Pi, Psi = tsw.window_maps(sw, win)
    norm = [float(torch.linalg.matrix_norm(M.double(), ord=2).max())
            for M in (Pi, Psi)]
    held(f"{tag}, P={P} ({FLEX_HOLD_ITERS} it warm); the parallel sweep, "
         f"{pl.cluster} windows of {win[1]}–{-(-sw.N // pl.cluster)} stages, "
         f"max ‖Π_k‖ {norm[0]:.4f}, max ‖Ψ_k‖ {norm[1]:.4f}",
         "k5_horizon_par_wide" if sw.b > 8 else "k5_horizon_par",
         {k: (g, r) for k, g, r in zip(K5_FIELDS, got, ref) if g is not None})
    k5_err_into(rec, got, ref)
    rec[("hull_" if key == "hull" else "") + "window_map_norms"] = norm
    if not TIMINGS:
        return
    pre = "par_" if key == "di" else f"{key}_par_"
    rec[pre + "ms"] = cuda_ms(wrapper)
    rec[pre + "kernel_ms"] = kernel_ms(wrapper)
    rec[pre + "plain_ms"] = cuda_ms(plain, reps=1)
    rec[pre + "bound_ms"], by = bound(*k5_work(held_args))
    rec[pre + "relax_kernel_ms"] = kernel_ms(
        lambda: cs.sw_admm_cuda(*args, parallel=True))
    rec[pre + "relax_bound_ms"] = bound(*k5_work(args))[0]
    rec[pre + "chain_ms"] = K5_RELAX * horizon_chain_ms(sw.N, sw.b,
                                                        pl.cluster)
    print(f"  the parallel sweep: wrapper {rec[pre + 'ms']:.3f} ms, kernel "
          f"alone {rec[pre + 'kernel_ms']:.3f} ms, plain "
          f"{rec[pre + 'plain_ms']:.3f} ms, bound {rec[pre + 'bound_ms']:.4f} "
          f"ms ({by}) ({FLEX_HOLD_ITERS} it); the relaxation ({K5_RELAX} "
          f"it) alone {rec[pre + 'relax_kernel_ms']:.3f} ms, bound "
          f"{rec[pre + 'relax_bound_ms']:.4f} ms, chain floor "
          f"{rec[pre + 'chain_ms']:.3f} ms", flush=True)


def phase_k5_flex(dev, rng, recs):
    """K5's FLEX and horizon variants against the plain loop
    (``_admm_iterations``, the plain sweeps, on the card) at every shape a
    path runs them at (``flex_waves``): FLEX_HOLD_ITERS iterations from the
    kernel's own relaxation (K5_RELAX iterations, cold), within "k5_flex"
    ("k5_flex_wide" at the hull model's b=13); the plan's variant must be
    the one named; at the long horizons also the global variant forced
    (the one the horizon variant replaced) and ``horizon_holds``; at the
    double integrator also global_all forced; at the wide trees the plan
    must run the wave's P/S clusters, portable, in one wave of the card,
    and the grouped variant's earlier placement (⌈S/16⌉ scenarios a CTA)
    is held too, forced. At config 6's long-arm wave
    the grouped, global and global_all variants forced against the shared
    one (the plan's there), a whole relaxation warm: x, z, y, dy and the
    extra rows' carries bitwise equal (each row's update is the same
    thread's in the same order; the group mean skips zero weights). Times
    of each variant alone, of its wrapper and of the plain loop (held
    iterations), the kernel also at K5_RELAX iterations, the bound and the
    chain floor."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw
    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        assemble_stagewise_tree_ext)

    names = K5_FIELDS
    plan_of, err_into = k5_plan_of, k5_err_into
    print("K5's grouped and global-state variants vs the plain loop:",
          flush=True)

    for tag, key, be, fb, hb, lb, ub, kernel in flex_waves(dev, rng):
        with k5_calls() as calls:
            be.solve(fb, hb, lb, ub, K5_RELAX)
        args = calls[0]
        P, pl = plan_of(args)
        sw = args[0]
        check(cs.ADMM_LAUNCH[pl.variant] == kernel,
              f"{tag}: the plan is {pl}, not {kernel}")
        out = cs.sw_admm_cuda(*args)
        held_args = with_warm(args, out, FLEX_HOLD_ITERS)
        ref = tsw._admm_iterations(*held_args)
        rec = recs[kernel]
        hz = pl.variant == "horizon"
        S = args[11].shape[0] if key.startswith("tree") else 1
        # (the forced plan's record prefix, its keywords): the plan's; the
        # global variant the horizon one replaced; global_all; at the wide
        # trees the grouped variant's earlier placement (⌈S/16⌉ scenarios
        # a CTA, non-portable clusters)
        forcings = ([("", {})] + ([("", dict(variant="global"))] if hz else [])
                    + ([("", dict(variant="global_all"))] if key == "di"
                       else [])
                    + ([("parent_", dict(variant="grouped",
                                          spc=-(-S // cs.ADMM_CLUSTER_MAX)))]
                       if S > 1 else []))
        for _, kw in forcings:
            pv = plan_of(args, **kw)[1]
            got = cs.sw_admm_cuda(*held_args, **kw)
            held_at = ([cs.horizon_capacity(sw.N, sw.b, sw.m_k, pv,
                                            args[1].device)]
                       if pv.variant == "horizon" else
                       [v for k, v in sw.cache.items()
                        if k[0] == "k5_clusters" and k[1] == pv])
            waves = f", {-(-(P // S) // held_at[0])} wave(s) of {P // S}" \
                if held_at and S > 1 else ""
            held(f"{tag}, P={P} m={sw.m_k} ({FLEX_HOLD_ITERS} it warm); "
                 + ("forced " if kw else "the plan: ")
                 + f"{pv.variant} (place {cs.ADMM_PLACES.get(pv.variant)}), "
                 f"bmax {pv.bmax}, "
                 f"{'staged' if pv.staged else 'factors through L2'}, "
                 f"{32 * pv.warps} threads and {pv.smem} bytes a CTA, "
                 f"{pv.spc} scenario(s) a CTA, clusters of {pv.cluster}"
                 + (f", member lists {'staged' if pv.lists else 'in device memory'}"
                    if S > 1 else "")
                 + (f" ({held_at[0]} at once on the card{waves})" if held_at
                    else ""),
                 "k5_flex_wide" if sw.b > 8 else "k5_flex",
                 {k: (g, r) for k, g, r in zip(names, got, ref)
                  if g is not None})
            err_into(recs[cs.ADMM_LAUNCH[pv.variant]], got, ref)
            if S > 1 and not kw:
                check(pv.cluster <= cs.ADMM_CLUSTER and held_at
                      and P // S <= held_at[0],
                      f"{tag}: the plan {pv} does not run P/S = {P // S} "
                      f"portable clusters in one wave ({held_at})")
        if hz:
            horizon_holds(tag, key, args, out, held_args, pl, rec)
        if not TIMINGS:
            continue
        plain_ms = None            # the shape's plain loop, timed once
        for parent, kw in forcings:
            r = recs[cs.ADMM_LAUNCH[kw.get("variant") or pl.variant]]
            # each record's first shape is its main one (no prefix)
            pre = ("" if not parent and "kernel_ms" not in r
                   else f"{key}_{parent}")

            def wrapper():
                return cs.sw_admm_cuda(*held_args, **kw)

            if plain_ms is None:
                by = timed(r, pre, wrapper,
                           lambda: tsw._admm_iterations(*held_args),
                           k5_work(held_args))
                plain_ms = r[pre + "plain_ms"]
            else:
                r[pre + "ms"] = cuda_ms(wrapper)
                r[pre + "kernel_ms"] = kernel_ms(wrapper)
                r[pre + "plain_ms"] = plain_ms
                r[pre + "bound_ms"], by = bound(*k5_work(held_args))
                print(f"  {kw or 'the plan'}: wrapper {r[pre + 'ms']:.3f} ms, "
                      f"kernel alone {r[pre + 'kernel_ms']:.3f} ms (the plain "
                      f"loop and the bound as above)", flush=True)
            r[pre + "relax_kernel_ms"] = kernel_ms(
                lambda: cs.sw_admm_cuda(*args, **kw))
            r[pre + "relax_bound_ms"] = bound(*k5_work(args))[0]
            r[pre + "chain_ms"] = K5_RELAX * k4_chain_ms(sw.N, sw.b)
            if not pre:
                r["bound_by"] = by
                r["library_ms"] = None   # no PyTorch call runs an ADMM loop
            print(f"  {kw or pl.variant}: the relaxation "
                  f"({K5_RELAX} it) alone {r[pre + 'relax_kernel_ms']:.3f} "
                  f"ms, bound {r[pre + 'relax_bound_ms']:.4f} ms, chain "
                  f"floor {r[pre + 'chain_ms']:.3f} ms", flush=True)

    # the forced variants at config 6's long-arm wave against the shared one
    tree_l = config6_trees()[1]
    swt, _ = config6_preps(dev, tree_l, config6_extra(CFG6_N))
    eu = assemble_stagewise_tree_ext(swt, torch.tensor(X0_6, device=dev))
    be, fb, hb, lb, ub = node_wave(swt, eu, rng, CFG6_SPEC["wave_size"],
                                   K4_HOLD_FIX)
    with k5_calls() as calls:
        r0 = be.solve(fb, hb, lb, ub, K5_RELAX)
        be.solve(fb, hb, lb, ub, K5_RELAX, warm=(r0.x, r0.z, r0.y))
    args = calls[1]
    P, pl = plan_of(args)
    check(pl.variant == "shared", f"config 6's long arm left the shared "
          f"variant: {pl}")
    want = cs.sw_admm_cuda(*args)
    for variant in ("grouped", "global", "global_all"):
        pv = plan_of(args, variant)[1]
        got = cs.sw_admm_cuda(*args, variant=variant)
        same = [k for k, g, w in zip(names, got, want)
                if g is not None and torch.equal(g, w)]
        print(f"  config 6 long arm, P={P}, relaxation warm ({K5_RELAX} "
              f"it): {variant} ({32 * pv.warps} threads, {pv.smem} bytes "
              f"a CTA, clusters of {pv.cluster}) bitwise the shared "
              f"variant's on {same}", flush=True)
        check(len(same) == sum(g is not None for g in got),
              f"config 6 long arm: the {variant} variant differs from the "
              f"shared one")
        BITWISE[0] += 1
        if TIMINGS:
            r = recs[cs.ADMM_LAUNCH[variant]]
            r["cfg6_forced_kernel_ms"] = kernel_ms(
                lambda: cs.sw_admm_cuda(*args, variant=variant))
            print(f"    alone {r['cfg6_forced_kernel_ms']:.3f} ms, the "
                  f"shared variant {kernel_ms(lambda: cs.sw_admm_cuda(*args)):.3f} "
                  f"ms", flush=True)


def window_overhead(P, N, b, windows):
    """(bytes, {type: operations}) that one window-parallel sweep of P
    problems over ``windows`` windows does beyond the sequential one: per
    problem the carries, C−1 b×b products each way, and the corrections, a
    b×b product at each stage past the first window (forward) and before
    the last (backward), each product b² FMAs and b adds; the window maps
    read once, Π at those stages and at the first window's end, Ψ at those
    and at the last window's start."""
    from pyhybridcontrol_tpu_torch.ops.cuda_stagewise import horizon_windows

    if windows < 2:
        return 0, dict(fp32=0)
    w = horizon_windows(N, windows)
    fwd, bwd = N - w[1], w[windows - 1]
    products = 2 * (windows - 1) + fwd + bwd
    return (4 * (fwd + bwd + 2) * b * b,
            dict(fp32=P * products * (2 * b * b + b)))


def par_overhead(args, windows):
    """(bytes, {type: operations}) that K5's parallel sweep over
    ``windows`` windows does beyond the function's own work (``k5_work``,
    which is what its bound counts), as the kernel does it:
    ``window_overhead``'s operations every iteration, its maps read once."""
    sw, q, iters = args[0], args[1], args[10]
    nbytes, ops = window_overhead(q.numel() // (sw.N * sw.b), sw.N, sw.b,
                                  windows)
    return nbytes, dict(fp32=iters * ops["fp32"])


def windowed_bound_ms(args, windows):
    """The bound of K5's parallel sweep with its windowed work counted
    too (``k5_work`` plus ``par_overhead``)."""
    (nb, ops), (ob, oo) = k5_work(args), par_overhead(args, windows)
    return bound(nb + ob, dict(fp32=ops["fp32"] + oo["fp32"]))[0]


def par_waves(dev, rng):
    """(tag, key, backend, f, h, lb, ub, variant, regime) of a wave of
    nodes at each shape K5's parallel sweep runs on a path, and two more:
    config 6's long arm (its relaxation's prep and its probes' at ρ·10;
    the shared variant), the same with 5 extra rows (the runtime-r path
    at bmax 8), the battery fleet (its relaxation's prep and its probes';
    the global variant at bmax 32), the three wide trees (WIDE_VARIANT)
    and 32 batteries at N=24 (b = 128, the global variant at bmax 128);
    ``variant`` the one the plan picks, ``regime`` the limits."""
    import torch

    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        assemble_stagewise_tree_ext)
    from pyhybridcontrol_tpu_torch.solver.bnb_stagewise import (
        StagewiseBackend)

    out = []
    x6 = torch.tensor(X0_6, device=dev)
    tree_l = config6_trees()[1]
    swt, swtp = config6_preps(dev, tree_l, config6_extra(CFG6_N))
    eu = assemble_stagewise_tree_ext(swt, x6)
    wave = node_wave(swt, eu, rng, CFG6_SPEC["wave_size"], K4_HOLD_FIX)
    out.append(("config 6 long arm, relaxation", "cfg6", *wave, "shared",
                "k5_par"))
    probe = node_wave(swtp, eu, rng, CFG6_SPEC["wave_size"], K4_HOLD_FIX)
    out.append(("config 6 long arm, probe (ρ·10)", "cfg6_probe", *probe,
                "shared", "k5_par_probe"))
    swt5 = config6_preps(dev, tree_l, config6_rows(5))[0]
    out.append(("config 6 long arm, 5 extra rows", "cfg6_rt",
                *node_wave(swt5, assemble_stagewise_tree_ext(swt5, x6), rng,
                           CFG6_SPEC["wave_size"], K4_HOLD_FIX), "shared",
                "k5_par_rt"))
    c, be, fb, hb, lb, ub = fleet_wave(dev, rng, FLEET_M, FLEET_N)
    out.append((f"battery_fleet ({FLEET_M} batteries, N={FLEET_N}), "
                f"relaxation", "fleet", be, fb, hb, lb, ub, "global",
                "k5_par_any"))
    out.append(("battery_fleet, probe (ρ·10)", "fleet_probe",
                StagewiseBackend(c._sw_probe, ext_u=be.ext_u), fb, hb, lb,
                ub, "global", "k5_par_any_probe"))
    for S, steps in WIDE_TREES:
        swt = config6_preps(dev, wide_tree(S, steps), config6_extra(CFG6_N))[0]
        out.append((f"config 6's tree at S={S}", f"tree{S}",
                    *node_wave(swt, assemble_stagewise_tree_ext(swt, x6),
                               rng, WIDE_SPEC["wave_size"], K4_HOLD_FIX),
                    WIDE_VARIANT[S].replace("stagewise_k5_", ""), "k5_par"))
    out.append(("32 batteries, N=24 (b=128)", "fleet128",
                *fleet_wave(dev, rng, 32, 24)[1:], "global", "k5_par_any"))
    return out


# the shapes phase 22 holds the sequential sweep at that the parallel one
# is held at too (k5_waves' keys): windows of one stage (the parity arm,
# N=4) and of one or two (the served double integrator, N=10), soft rows,
# blocking, a terminal set and a budget row, bmax 16 (the hull model,
# b=13) and bmax 8 without b=5's instantiation (b=6)
PAR_SMALL = ("cfg6_parity", "serve_sw", "transforms", "soft_box", "hull",
             "di_two_forces")


def phase_k5_par(dev, rng, recs):
    """K5's parallel sweep inside the shared and FLEX variants against its
    plain version (``_admm_iterations`` with ``_solve_K_windowed`` on the
    plan's windows, on the card) at every shape of ``par_waves``:
    FLEX_HOLD_ITERS iterations from the sequential sweep's own relaxation
    (K5_RELAX iterations, cold), within the regime's limits ("k5_par",
    "k5_par_probe", "k5_par_rt", "k5_par_any", "k5_par_any_probe"); the
    parallel plan must be the sequential
    plan's variant, placement and extra-row path, with at least 2 windows
    and no factor ring. Each held shape goes into its record
    (``instantiations``), with (TIMINGS) the parallel sweep's time alone
    and around its wrapper at the held iterations, the plain version's,
    the bound (``k5_work``: the function's own work; with the windowed
    work counted too, ``windowed_bound_ms``) and both chain floors (``horizon_chain_ms``
    at the plan's windows, ``k4_chain_ms`` for the sequential sweep); and
    the relaxation alone in both sweeps, in turns (sequential, parallel,
    parallel, sequential). Then, held only, at the shapes of PAR_SMALL
    ("k5_par_small"; at the single scenarios, whose parallel plan is the
    horizon variant's, the sequential plan's variant forced, its
    relaxation timed against the horizon variant's in turns) and the
    staged wide ones of phase 37 (five batteries, b=20; the ω tree, S=16
    grouped; "k5_par_any")."""
    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

    print("K5's parallel sweep inside the shared and FLEX variants vs its "
          "plain version:", flush=True)
    for tag, key, be, fb, hb, lb, ub, want, regime in par_waves(dev, rng):
        with k5_calls() as calls:
            be.solve(fb, hb, lb, ub, K5_RELAX)
        args = calls[0]
        sw = args[0]
        P, seq = k5_plan_of(args)
        check(seq.variant == want, f"{tag}: the plan is {seq}, not {want}")
        out = cs.sw_admm_cuda(*args)
        held_args = with_warm(args, out, FLEX_HOLD_ITERS)
        # the plan's variant, and at config 6's long arm the FLEX ones
        # forced (global_all runs on no path)
        for variant in (None,) + (ANY_FORCED if key == "cfg6" else ()):
            sq = k5_plan_of(args, variant)[1]
            pl = k5_plan_of(args, variant, parallel=True)[1]
            check(pl.variant == sq.variant and pl.windows >= 2
                  and pl.ring == 0
                  and (pl.spc, pl.cluster, pl.staged, pl.ext, pl.warps,
                       pl.tps) == (sq.spc, sq.cluster, sq.staged, sq.ext,
                                   sq.warps, sq.tps),
                  f"{tag}: the parallel plan {pl} is not the sequential "
                  f"plan {sq} with its windows")
            win = cs.horizon_windows(sw.N, pl.windows)

            def plain(a=held_args, w=win):
                return tsw._admm_iterations(
                    *a, sweep=lambda s, t: tsw._solve_K_windowed(s, t, w))

            def wrapper(a=held_args, v=variant):
                return cs.sw_admm_cuda(*a, variant=v, parallel=True)

            got, ref = wrapper(), plain()
            held(f"{tag} (b={sw.b}, m={sw.m_k}, n_ext={sw.n_ext}), P={P} "
                 f"({FLEX_HOLD_ITERS} it warm); "
                 + ("forced " if variant else "")
                 + f"the parallel sweep, {pl.windows} windows of "
                 f"{win[1]}–{-(-sw.N // pl.windows)} stages, in "
                 f"{describe_plan(pl)}", regime,
                 {k: (g, r) for k, g, r in zip(K5_FIELDS, got, ref)
                  if g is not None})
            rec = recs[pl.launch]
            k5_err_into(rec, got, ref)
            entry = dict(shape=tag, b=sw.b, N=sw.N, m=sw.m_k,
                         n_ext=sw.n_ext, P=P, variant=pl.variant,
                         bmax=pl.bmax, ext=pl.ext, staged=pl.staged,
                         threads=32 * pl.warps, smem=pl.smem,
                         windows=pl.windows, max_abs_err=max(
                             float((g - r).abs().max())
                             for g, r in zip(got, ref) if g is not None))
            rec.setdefault("instantiations", []).append(entry)
            if not TIMINGS:
                continue
            pre = "" if "kernel_ms" not in rec else f"{key}_"
            by = timed(rec, pre, wrapper, plain, k5_work(held_args))
            rec[pre + "windowed_bound_ms"] = windowed_bound_ms(held_args,
                                                               pl.windows)
            rec[pre + "chain_ms"] = FLEX_HOLD_ITERS * horizon_chain_ms(
                sw.N, sw.b, pl.windows)
            if not pre:
                rec["bound_by"] = by
                rec["library_ms"] = None   # no PyTorch call runs an ADMM loop
            relax = [kernel_ms(lambda: cs.sw_admm_cuda(
                *args, variant=variant, parallel=par), reps=3)
                for par in (False, True, True, False)]
            entry.update(
                ms=rec[pre + "ms"], kernel_ms=rec[pre + "kernel_ms"],
                plain_ms=rec[pre + "plain_ms"],
                bound_ms=rec[pre + "bound_ms"], chain_ms=rec[pre + "chain_ms"],
                windowed_bound_ms=rec[pre + "windowed_bound_ms"],
                seq_kernel_ms=kernel_ms(lambda: cs.sw_admm_cuda(
                    *held_args, variant=variant)),
                seq_chain_ms=FLEX_HOLD_ITERS * k4_chain_ms(sw.N, sw.b),
                relax_seq_kernel_ms=[relax[0], relax[3]],
                relax_par_kernel_ms=relax[1:3],
                relax_bound_ms=bound(*k5_work(args))[0],
                relax_windowed_bound_ms=windowed_bound_ms(args, pl.windows),
                relax_chain_ms=K5_RELAX * horizon_chain_ms(sw.N, sw.b,
                                                           pl.windows),
                relax_seq_chain_ms=K5_RELAX * k4_chain_ms(sw.N, sw.b))
            print(f"    with the windowed work counted too, bound "
                  f"{entry['windowed_bound_ms']:.4f} ms ({FLEX_HOLD_ITERS} "
                  f"it), {entry['relax_windowed_bound_ms']:.4f} ms "
                  f"({K5_RELAX} it)", flush=True)
            print(f"    the sequential sweep alone "
                  f"{entry['seq_kernel_ms']:.3f} ms ({FLEX_HOLD_ITERS} it), "
                  f"chain floor {entry['seq_chain_ms']:.3f} ms against the "
                  f"parallel {entry['chain_ms']:.3f} ms; the relaxation "
                  f"({K5_RELAX} it) alone, sequential / parallel / parallel "
                  f"/ sequential: " + " / ".join(f"{v:.3f}" for v in relax)
                  + f" ms, bound {entry['relax_bound_ms']:.4f} ms, chain "
                  f"floors {entry['relax_seq_chain_ms']:.3f} / "
                  f"{entry['relax_chain_ms']:.3f} ms", flush=True)

    small = [(t, be, *w) for t, key, be, _, *w in k5_waves(dev, rng)
             if key in PAR_SMALL]
    small += [(t, be, fb, hb, lb, ub) for t, be, fb, hb, lb, ub, *_ in
              any_waves(dev, rng)
              if t.startswith(("5 batteries", f"{ANY_TREE_UNITS} ω"))]
    for tag, be, fb, hb, lb, ub in small:
        with k5_calls() as calls:
            be.solve(fb, hb, lb, ub, K5_RELAX)
        args = calls[0]
        sw = args[0]
        # where the parallel plan is the horizon variant's (one scenario),
        # the parallel sweep inside the sequential plan's variant forced
        forced = k5_plan_of(args)[1].variant \
            if k5_plan_of(args, parallel=True)[1].variant == "horizon" \
            else None
        P, pl = k5_plan_of(args, forced, parallel=True)
        check(pl.windows >= min(2, sw.N), f"{tag}: the plan {pl}")
        held_args = with_warm(args, cs.sw_admm_cuda(*args), FLEX_HOLD_ITERS)
        win = cs.horizon_windows(sw.N, pl.windows)
        got = cs.sw_admm_cuda(*held_args, parallel=True, variant=forced)
        ref = tsw._admm_iterations(
            *held_args, sweep=lambda s, t, w=win: tsw._solve_K_windowed(
                s, t, w))
        held(f"{tag} (N={sw.N}, b={sw.b}, m={sw.m_k}, n_ext={sw.n_ext}), "
             f"P={P} ({FLEX_HOLD_ITERS} it warm); the parallel sweep, "
             f"{pl.windows} windows of {win[1]}–{-(-sw.N // pl.windows)} "
             f"stages, in " + ("forced " if forced else "")
             + describe_plan(pl),
             "k5_par_any" if sw.b > 16 else "k5_par_small",
             {k: (g, r) for k, g, r in zip(K5_FIELDS, got, ref)
              if g is not None})
        rec = recs[pl.launch]
        k5_err_into(rec, got, ref)
        entry = dict(
            shape=tag, b=sw.b, N=sw.N, m=sw.m_k, n_ext=sw.n_ext, P=P,
            variant=pl.variant, bmax=pl.bmax, ext=pl.ext, staged=pl.staged,
            threads=32 * pl.warps, smem=pl.smem, windows=pl.windows,
            max_abs_err=max(float((g - r).abs().max())
                            for g, r in zip(got, ref) if g is not None))
        rec.setdefault("instantiations", []).append(entry)
        if TIMINGS and forced:
            # the parallel plan (the horizon variant's cluster sweep)
            # against the parallel sweep inside the sequential plan's
            # variant, the relaxation alone in turns
            hz = k5_plan_of(args, parallel=True)[1]
            t = [kernel_ms(lambda: cs.sw_admm_cuda(
                *args, parallel=True, variant=v), reps=3)
                for v in ("horizon", forced, forced, "horizon")]
            entry.update(relax_horizon_par_kernel_ms=[t[0], t[3]],
                         relax_par_kernel_ms=t[1:3],
                         relax_bound_ms=bound(*k5_work(args))[0],
                         relax_horizon_chain_ms=K5_RELAX * horizon_chain_ms(
                             sw.N, sw.b, hz.cluster),
                         relax_chain_ms=K5_RELAX * horizon_chain_ms(
                             sw.N, sw.b, pl.windows))
            print(f"    the relaxation ({K5_RELAX} it) alone, the horizon "
                  f"variant's parallel sweep ({describe_plan(hz)}) / "
                  f"{pl.variant}'s / {pl.variant}'s / the horizon "
                  f"variant's: " + " / ".join(f"{v:.3f}" for v in t)
                  + f" ms; bound {entry['relax_bound_ms']:.3g} ms, chain "
                  f"floors {entry['relax_horizon_chain_ms']:.4f} (C="
                  f"{hz.cluster}) / {entry['relax_chain_ms']:.4f} ms (C="
                  f"{pl.windows})", flush=True)


# battery_fleet: fleet dispatch of storage over a day, the use the
# stagewise frame is for (docs/MIGRATION.md:131-151, long horizons). Eight
# default batteries (models/battery.py: nx 1, nv 3, b 4 each) aggregated
# (mld/compose.aggregate_mld) with the feeder limit |Σ_i p_i| ≤
# FLEET_FEEDER kW as coupling rows: b = 32, m = 122 a stage, 8 binaries a
# stage; a day at BatteryParams.Ts_h (N = 96) on the stagewise frame; the
# horizon-coupled rows one export cap a battery (−Σ_k p_i,k ≤
# FLEET_EXPORT) and one import cap a window of FLEET_WINDOW steps (Σ over
# the window and the batteries ≤ FLEET_IMPORT), 8 + 12 = 20; the TOU price
# of models/grid.default_tou_profile on each p; SoC from 0.3 to 0.7.
FLEET_M, FLEET_N = 8, 96
FLEET_FEEDER, FLEET_EXPORT, FLEET_IMPORT, FLEET_WINDOW = 20.0, 20.0, 96.0, 8
FLEET_SPEC = dict(capacity=256, wave_size=8, max_waves=8, qp_iters=150,
                  probe_iters=1000)
# the JAX package's objective on this setup on the CPU (a reading printed
# beside the port's; JAX_PLATFORMS=cpu python tools/fleet_reference.py)
FLEET_REF_OBJ = -24.408065795898438
# the same with sw_parallel=True (the log-depth sweeps;
# JAX_PLATFORMS=cpu python tools/fleet_reference.py --parallel)
FLEET_REF_OBJ_PAR = -24.408023834228516


# ---- K5 at any b and r -----------------------------------------------------

# the shapes past the register path (phase 37): battery fleets (M
# batteries, N steps; fleet_controller) at b = 20, 32 (battery_fleet's),
# 64 and 128; the first also forced through ANY_FORCED
ANY_FLEETS = ((5, 8), (8, FLEET_N), (16, 48), (32, 24))
ANY_FORCED = ("grouped", "global", "global_all")
# four of config 6's ω double integrators aggregated (b = 20, nω = 4) in a
# tree of S = 16 branching at ANY_TREE_STEPS of N = ANY_TREE_N, a budget
# Σ_k u_i,k ≤ ANY_TREE_BUDGET a unit (4 extra rows)
ANY_TREE_UNITS, ANY_TREE_S, ANY_TREE_N = 4, 16, 24
ANY_TREE_STEPS, ANY_TREE_BUDGET = (1, 6, 12, 18), 12.0
# config 6's long arm with this many extra rows (config6_rows)
CFG6_EXT_ROWS = (5, 20, 300)


def config6_rows(r, N=CFG6_N):
    """``r`` horizon-coupled rows on config 6's u: Σ_k u_k over a window
    at most the window's share of CFG6_BUDGET; r ≤ N windows tile the
    horizon, past N row j takes 1 + j div N steps from step j mod N."""
    import numpy as np

    A_v, b = np.zeros((r, N * 3)), np.zeros(r)
    for j in range(r):
        k0, k1 = ((j * N // r, (j + 1) * N // r) if r <= N
                  else (j % N, min(N, j % N + 1 + j // N)))
        A_v[j, 3 * k0:3 * k1:3] = 1.0
        b[j] = CFG6_BUDGET * (k1 - k0) / N
    return (A_v, b, None, None)


def omega_fleet_tree(dev):
    """(stagewise tree prep, x0) of ANY_TREE_UNITS of config 6's ω double
    integrators aggregated, on a tree of ANY_TREE_S scenarios
    (tree-consistent paths of sd 0.2 from default_rng(ANY_TREE_S), one
    disturbance channel a unit) with a budget row a unit."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.mld.compose import aggregate_mld
    from pyhybridcontrol_tpu_torch.models import di_default_weights
    from pyhybridcontrol_tpu_torch.ops.condense import MpcWeights
    from pyhybridcontrol_tpu_torch.ops.scenario_tree import (
        ScenarioTree, tree_consistent_paths)
    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        prepare_stagewise_tree)

    n, N = ANY_TREE_UNITS, ANY_TREE_N
    model = aggregate_mld([omega_model() for _ in range(n)])
    w0 = di_default_weights()
    w = MpcWeights(Qx=np.tile(w0.Qx, n), QxN=np.tile(w0.QxN, n),
                   Ru=np.tile(w0.Ru, n), qdelta=np.tile(w0.qdelta, n))
    rng = np.random.default_rng(ANY_TREE_S)
    tree = ScenarioTree.from_branching(
        tree_consistent_paths(rng, ANY_TREE_S, N, ANY_TREE_STEPS, sd=0.2,
                              nomega=n), branch_steps=ANY_TREE_STEPS)
    nv = model.info.nv
    A_v = np.zeros((n, N * nv))
    for i in range(n):
        A_v[i, i::nv] = 1.0
    swt = prepare_stagewise_tree(
        model, tree, w, device=dev,
        extra=(A_v, np.full(n, ANY_TREE_BUDGET), None, None))
    x0 = np.concatenate([[2.0 * f, 0.0] for f in np.linspace(0.5, 1.4, n)])
    return swt, x0


def fleet_wave(dev, rng, M, N):
    """(controller, backend, f, h, lb, ub): a wave of FLEET_SPEC's size at
    an M-battery fleet's frame (its price and x0), K4_HOLD_FIX of the
    binaries fixed at random."""
    import torch

    from pyhybridcontrol_tpu_torch.ops.stagewise import (
        assemble_stagewise, assemble_stagewise_ext)
    from pyhybridcontrol_tpu_torch.solver.bnb_stagewise import (
        StagewiseBackend, pack_stagewise_data)

    c, price, x0, _ = fleet_controller(M, N, dev)
    xt = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    pt = torch.as_tensor(price, dtype=torch.float32, device=dev)
    be = StagewiseBackend(c._sw, ext_u=assemble_stagewise_ext(c._sw, xt))
    f, h = pack_stagewise_data(*assemble_stagewise(c._sw, xt, price_seq=pt))
    return (c, be, *wave_boxes(be, f, h, FLEET_SPEC["wave_size"], rng,
                               K4_HOLD_FIX))


def any_waves(dev, rng):
    """(tag, backend, f, h, lb, ub, variant, forced, regime) of a wave of
    nodes at each shape of phase 37: the plan's variant expected, the
    variants also held forced, the limits."""
    import torch

    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        StagewiseTreeBackend, assemble_stagewise_tree,
        assemble_stagewise_tree_ext, pack_stagewise_tree_data)

    out = []
    for M, N in ANY_FLEETS:
        c, be, fb, hb, lb, ub = fleet_wave(dev, rng, M, N)
        out.append((f"{M} batteries, N={N}", be, fb, hb, lb, ub,
                    "shared" if M == 5 else "global",
                    ANY_FORCED if M == 5 else (), "k5_any"))
    swt, x0 = omega_fleet_tree(dev)
    xt = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    be = StagewiseTreeBackend(swt,
                              ext_u=assemble_stagewise_tree_ext(swt, xt))
    f, h = pack_stagewise_tree_data(*assemble_stagewise_tree(swt, xt))
    out.append((f"{ANY_TREE_UNITS} ω double integrators, S={ANY_TREE_S}, "
                f"N={ANY_TREE_N}", be,
                *wave_boxes(be, f, h, 8, rng, K4_HOLD_FIX), "grouped", (),
                "k5_any"))
    tree_l = config6_trees()[1]
    x6 = torch.tensor(X0_6, device=dev)
    for r in CFG6_EXT_ROWS:
        swt = config6_preps(dev, tree_l, config6_rows(r))[0]
        eu = assemble_stagewise_tree_ext(swt, x6)
        out.append((f"config 6 long arm, {r} extra rows",
                    *node_wave(swt, eu, rng, CFG6_SPEC["wave_size"],
                               K4_HOLD_FIX), "shared", (), "k5_rt"))
    return out


def describe_plan(pl):
    """A K5 plan in words."""
    where = [n for bit, n in ((2, "Aext/KiU"), (4, "Cw"), (16, "J/Mc"),
                              (8, "the r-vectors")) if pl.ext & bit]
    return (f"{pl.variant}, bmax {pl.bmax}, "
            + ("register path" if not pl.ext else "runtime r" + (
                f" ({', '.join(where)} in device memory)" if where else ""))
            + f", {'staged' if pl.staged else 'factors through L2'}, "
            f"{32 * pl.warps} threads and {pl.smem} bytes a CTA, "
            f"{pl.spc} scenario(s) a CTA, clusters of {pl.cluster}")


def phase_k5_any(dev, rng, recs):
    """K5 past its register path against the plain loop
    (``_admm_iterations``, the plain sweeps, on the card) at every shape
    of ``any_waves``: FLEX_HOLD_ITERS iterations from the kernel's own
    relaxation (K5_RELAX iterations, cold), within "k5_any" (bmax 32 to
    128) or "k5_rt" (b = 5 with more than 4 extra rows); the plan's
    variant must be the one named, on the runtime-r path; at the five
    batteries also grouped, global and global_all forced. Each held
    instantiation goes into its variant's record (``instantiations``),
    with (TIMINGS) its time alone and around the wrapper at the held
    iterations and alone at a relaxation's, the plain loop's, the bounds
    and the chain floors. Then config 6's long-arm wave (one extra row)
    through the runtime-r path forced against the register path, a whole
    relaxation warm: every carry bitwise equal (each sum the same in the
    same order; b = 5 runs in bmax 8's generic instantiation, whose padded
    columns add exact zeros)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
    from pyhybridcontrol_tpu_torch.ops import stagewise as tsw
    from pyhybridcontrol_tpu_torch.ops.cuda_stagewise import sw_solve_k_cuda
    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        assemble_stagewise_tree_ext)

    print("K5 at any b and any number of extra rows vs the plain loop:",
          flush=True)
    for tag, be, fb, hb, lb, ub, want, forced, regime in any_waves(dev,
                                                                  rng):
        with k5_calls() as calls:
            be.solve(fb, hb, lb, ub, K5_RELAX)
        args = calls[0]
        sw = args[0]
        P, pl = k5_plan_of(args)
        check(pl.variant == want and pl.ext,
              f"{tag}: the plan is {pl}, not {want} on the runtime-r path")
        out = cs.sw_admm_cuda(*args)
        held_args = with_warm(args, out, FLEX_HOLD_ITERS)
        ref = tsw._admm_iterations(*held_args)
        plain_ms = (cuda_ms(lambda: tsw._admm_iterations(*held_args))
                    if TIMINGS else None)
        for variant in (None,) + forced:
            pv = k5_plan_of(args, variant)[1]
            got = cs.sw_admm_cuda(*held_args, variant=variant)
            held(f"{tag} (b={sw.b}, m={sw.m_k}, n_ext={sw.n_ext}), P={P} "
                 f"({FLEX_HOLD_ITERS} it warm); {describe_plan(pv)}", regime,
                 {k: (g, r) for k, g, r in zip(K5_FIELDS, got, ref)
                  if g is not None})
            rec = recs[cs.ADMM_LAUNCH[pv.variant]]
            k5_err_into(rec, got, ref)
            entry = dict(shape=tag, b=sw.b, N=sw.N, m=sw.m_k,
                         n_ext=sw.n_ext, P=P, variant=pv.variant,
                         bmax=pv.bmax, ext=pv.ext, staged=pv.staged,
                         threads=32 * pv.warps, smem=pv.smem,
                         max_abs_err=max(float((g - r).abs().max())
                                         for g, r in zip(got, ref)
                                         if g is not None))
            rec.setdefault("instantiations", []).append(entry)
            if not TIMINGS:
                continue

            def wrapper():
                return cs.sw_admm_cuda(*held_args, variant=variant)

            entry.update(
                ms=cuda_ms(wrapper), kernel_ms=kernel_ms(wrapper),
                plain_ms=plain_ms, bound_ms=bound(*k5_work(held_args))[0],
                chain_ms=FLEX_HOLD_ITERS * k4_chain_ms(sw.N, sw.b),
                relax_kernel_ms=kernel_ms(
                    lambda: cs.sw_admm_cuda(*args, variant=variant), reps=3),
                relax_bound_ms=bound(*k5_work(args))[0],
                relax_chain_ms=K5_RELAX * k4_chain_ms(sw.N, sw.b))
            print(f"    {pv.variant}: wrapper {entry['ms']:.3f} ms, alone "
                  f"{entry['kernel_ms']:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"bound {entry['bound_ms']:.4f} ms, chain floor "
                  f"{entry['chain_ms']:.3f} ms ({FLEX_HOLD_ITERS} it); the "
                  f"relaxation ({K5_RELAX} it) alone "
                  f"{entry['relax_kernel_ms']:.3f} ms, bound "
                  f"{entry['relax_bound_ms']:.4f} ms, chain floor "
                  f"{entry['relax_chain_ms']:.3f} ms", flush=True)
            if variant is None:
                # the share of an iteration that is its sweep: K4 alone
                # on the same factors (staged as K5's plan), one solve
                t = torch.randn((P, sw.N, sw.b), device=dev)
                entry["k4_sweep_ms"] = kernel_ms(
                    lambda: sw_solve_k_cuda(t, sw.factors, pv.staged))
                print(f"    K4's sweep alone on these factors "
                      f"({'staged' if pv.staged else 'through L2'}): "
                      f"{1e3 * entry['k4_sweep_ms']:.1f} µs a solve, K5 "
                      f"{1e3 * entry['kernel_ms'] / FLEX_HOLD_ITERS:.1f} µs "
                      f"an iteration", flush=True)

    # the runtime-r path forced at config 6's long arm against the
    # register path
    tree_l = config6_trees()[1]
    swt, _ = config6_preps(dev, tree_l, config6_extra(CFG6_N))
    eu = assemble_stagewise_tree_ext(swt, torch.tensor(X0_6, device=dev))
    be, fb, hb, lb, ub = node_wave(swt, eu, rng, CFG6_SPEC["wave_size"],
                                   K4_HOLD_FIX)
    with k5_calls() as calls:
        r0 = be.solve(fb, hb, lb, ub, K5_RELAX)
        be.solve(fb, hb, lb, ub, K5_RELAX, warm=(r0.x, r0.z, r0.y))
    args = calls[1]
    P, pl = k5_plan_of(args)
    pr = k5_plan_of(args, runtime_r=True)[1]
    check(pl.variant == "shared" and not pl.ext and pr.ext,
          f"config 6's long arm: plans {pl} / {pr}")
    want = cs.sw_admm_cuda(*args)
    got = cs.sw_admm_cuda(*args, runtime_r=True)
    same = [k for k, g, w in zip(K5_FIELDS, got, want)
            if g is not None and torch.equal(g, w)]
    print(f"  config 6 long arm, P={P}, relaxation warm ({K5_RELAX} it): "
          f"the runtime-r path ({describe_plan(pr)}) bitwise the register "
          f"path's on {same}", flush=True)
    check(len(same) == sum(g is not None for g in got),
          "config 6 long arm: the runtime-r path differs from the register "
          "path at one extra row")
    BITWISE[0] += 1
    if TIMINGS:
        r = recs["stagewise_k5"]
        r["cfg6_runtime_r_kernel_ms"] = kernel_ms(
            lambda: cs.sw_admm_cuda(*args, runtime_r=True))
        r["cfg6_register_kernel_ms"] = kernel_ms(
            lambda: cs.sw_admm_cuda(*args))
        print(f"    alone {r['cfg6_runtime_r_kernel_ms']:.3f} ms, the "
              f"register path {r['cfg6_register_kernel_ms']:.3f} ms",
              flush=True)


def phase_battery_fleet(dev):
    """The battery_fleet path through the entry point a user calls, with
    the plain loop and sweeps made to raise: ``fleet_controller``'s
    eight-battery fleet (N=96, 20 extra rows, b=32), one stagewise
    ``MpcController.feedback`` from its x0 with its TOU price; every
    relaxation and probe one launch of K5's global variant (bmax 32, the
    runtime-r path). Prints found, the objective beside the JAX package's
    (FLEET_REF_OBJ), nodes, relaxations and probes, u₀ and the solve's
    time; then a relaxation's and a probe's kernel time (their recorded
    launches again); the plan in fp64 (dynamics, stage rows, binaries,
    box, and the 20 extra rows) within FEAS_TOL."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs

    c, price, x0, (A_v, b_e) = fleet_controller(FLEET_M, FLEET_N, dev)
    sw = c._sw

    def solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = c.feedback(x0, price_seq=price)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    with no_plain_sweep(), solve_calls() as n, k5_calls() as calls:
        (r, sec), _ = drive("battery_fleet", solve)
    only_k5("battery_fleet", 1, n[0], kernel="stagewise_k5_global")
    its = [a[10] for a in calls]
    relax = [a for a in calls if a[10] == FLEET_SPEC["qp_iters"]]
    probes = [a for a in calls if a[10] == FLEET_SPEC["probe_iters"]]
    pl = k5_plan_of(calls[0])[1]
    obj = float(r.obj)
    rel = abs(obj - FLEET_REF_OBJ) / abs(FLEET_REF_OBJ)
    print(f"battery_fleet, {FLEET_M} batteries N={FLEET_N} (b={sw.b}, "
          f"m={sw.m_k}, n_ext={sw.n_ext}; {describe_plan(pl)}): "
          f"{sec:.2f} s, found {bool(r.found)}, {int(r.nodes)} nodes, "
          f"{len(relax)} relaxations and {len(probes)} probes (iterations "
          f"{sorted(set(its))}), objective {obj:.6f} (the JAX package on "
          f"the CPU: {FLEET_REF_OBJ:.6f}, relative difference {rel:.2e}), "
          f"u0 {r.u.cpu().numpy().tolist()}", flush=True)
    check(bool(r.found), "battery_fleet: no plan found")
    ms = {}
    for key, group in (("relaxation", relax), ("probe", probes)):
        if group:
            ms[key] = kernel_ms(lambda: cs.sw_admm_cuda(*group[0]), reps=3)
    print(f"  battery_fleet: {1e3 * sec:.1f} ms a solve; K5 alone "
          + ", ".join(f"{v:.3f} ms a {k}" for k, v in ms.items()),
          flush=True)
    xi = torch.cat([r.v_seq, r.x_seq], dim=1).double().cpu().numpy()
    sw_plan_feasible("battery_fleet plan", c.model, x0, xi)
    over = float((A_v @ xi[:, :sw.nv].reshape(-1) - b_e).max())
    print(f"  battery_fleet plan: extra rows max(A_v·V − b) = {over:.2e} "
          f"(limit {FEAS_TOL:g})", flush=True)
    check(over <= FEAS_TOL, "battery_fleet: the plan breaks an extra row")
    return dict(M=FLEET_M, N=FLEET_N, s=sec, found=bool(r.found), obj=obj,
                ref_obj=FLEET_REF_OBJ, nodes=int(r.nodes),
                relaxations=len(relax), probes=len(probes),
                u0=r.u.cpu().numpy().tolist(),
                relax_kernel_ms=ms.get("relaxation"),
                probe_kernel_ms=ms.get("probe"), extra_rows_over=over,
                parallel=fleet_parallel_twin(dev, r, sec, ms))


def fleet_parallel_twin(dev, res, seq_s, seq_ms):
    """battery_fleet's ``sw_parallel=True`` twin (the path
    battery_fleet_par): the same feedback, every relaxation and probe one
    launch of K5's parallel sweep in the global variant (bmax 32, the
    runtime-r path); found as the sequential solve ``res``, its objective
    within 1e-3 of that solve's and of the JAX package's with the log-depth
    sweeps (FLEET_REF_OBJ_PAR); a relaxation's and a probe's kernel time
    beside the sequential ones (``seq_ms``); the plan in fp64 with the 20
    extra rows; then read again warm (``long_warm_reading``)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs

    c, price, x0, (A_v, b_e) = fleet_controller(FLEET_M, FLEET_N, dev,
                                                 parallel=True)
    sw = c._sw

    def solve():
        return c.feedback(x0, price_seq=price)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with no_plain_sweep(), solve_calls() as n, k5_calls() as calls:
        r, _ = drive("battery_fleet_par", solve)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    only_k5("battery_fleet_par", 1, n[0], kernel="stagewise_k5_global_par")
    check(all(kw.get("parallel") for kw in calls.kw) and calls,
          "battery_fleet twin: a K5 call without the parallel sweep")
    pl = k5_plan_of(calls[0], parallel=True)[1]
    obj, seq = float(r.obj), float(res.obj)
    rel = abs(obj - seq) / max(1.0, abs(seq))
    rel_ref = abs(obj - FLEET_REF_OBJ_PAR) / abs(FLEET_REF_OBJ_PAR)
    ms = {}
    for key, its in (("relaxation", FLEET_SPEC["qp_iters"]),
                     ("probe", FLEET_SPEC["probe_iters"])):
        group = [a for a in calls if a[10] == its]
        if group:
            ms[key] = kernel_ms(lambda: cs.sw_admm_cuda(*group[0],
                                                        parallel=True),
                                reps=3)
    print(f"battery_fleet, the sw_parallel twin ({pl.windows} windows, "
          f"{describe_plan(pl)}): {sec:.2f} s (sequential {seq_s:.2f} s), "
          f"found {bool(r.found)}, {int(r.nodes)} nodes, {len(calls)} K5 "
          f"launches; objective {obj:.6f} against the sequential solve's "
          f"{seq:.6f} (relative {rel:.2e}) and the JAX package's with "
          f"sw_parallel {FLEET_REF_OBJ_PAR:.6f} (relative {rel_ref:.2e}; "
          f"limit 1e-3 each); K5 alone "
          + ", ".join(f"{v:.3f} ms a {k} (sequential "
                      f"{seq_ms.get(k, float('nan')):.3f})"
                      for k, v in ms.items()), flush=True)
    check(bool(r.found) == bool(res.found) and rel <= 1e-3
          and rel_ref <= 1e-3,
          "battery_fleet twin: off the sequential solve or the JAX "
          "package's")
    xi = torch.cat([r.v_seq, r.x_seq], dim=1).double().cpu().numpy()
    sw_plan_feasible("battery_fleet twin plan", c.model, x0, xi)
    over = float((A_v @ xi[:, :sw.nv].reshape(-1) - b_e).max())
    print(f"  battery_fleet twin plan: extra rows max(A_v·V − b) = "
          f"{over:.2e} (limit {FEAS_TOL:g})", flush=True)
    check(over <= FEAS_TOL, "battery_fleet twin: the plan breaks an extra "
          "row")
    return dict(s=sec, found=bool(r.found), obj=obj, seq_obj=seq,
                ref_obj=FLEET_REF_OBJ_PAR, nodes=int(r.nodes),
                windows=pl.windows, k5_launches=len(calls),
                relax_kernel_ms=ms.get("relaxation"),
                probe_kernel_ms=ms.get("probe"), extra_rows_over=over,
                profile=long_warm_reading("the sw_parallel twin", solve,
                                          path="battery_fleet_par"))


# fleet_b160 and its sw_parallel twin: fleet_controller(*FLEET_B160) (40
# batteries over N=24: b=160, 40 export rows and 3 import windows as extra
# rows), the FLEET_SPEC search; past K5's bmax 128, so the torch loop with
# K6 on the card
FLEET_B160 = (40, 24)
# the JAX package's objectives on this setup on the CPU, both sweeps (47
# nodes each; held within 1e-3 where both find a plan):
#   JAX_PLATFORMS=cpu python tools/fleet_reference.py --batteries 40 \
#       --horizon 24 [--parallel]
FLEET_B160_REF_OBJ = -35.68117904663086
FLEET_B160_REF_OBJ_PAR = -35.685585021972656


def no_k5_nor_plain_sweep():
    """Inside: K5's wrapper and the three plain sweeps raise, so a stagewise
    path on the card that reached them would fail (the torch loop itself
    may run: it is what carries K4's and K6's sweeps)."""
    return refused(("sw_admm_cuda",) + PLAIN_SWEEPS,
                   "K5 or a plain sweep past K5's shapes")


def phase_fleet_b160(dev, profiled=("fleet_b160", "fleet_b160_par")):
    """The fleet_b160 paths through the entry point a user calls: one
    stagewise ``MpcController.feedback`` of ``fleet_controller(40, 24)``
    (b=160, 43 extra rows) at FLEET_SPEC, then the same with
    ``sw_parallel=True`` (fleet_b160_par), with K5 and the three plain
    sweeps made to raise: every relaxation and probe the torch loop on the
    card with K6's sweep (sequential; over ``any_windows(24)`` windows).
    Prints and holds found, nodes, the relaxations and probes run, the
    objective within 1e-3 of the JAX package's CPU reading (where both find
    a plan), the plan in fp64 with its extra rows (FEAS_TOL), K6's launches
    (one a relaxation or probe, no K5's); then, for the paths of
    ``profiled``, a warm re-solve's time and its idle share under
    torch.profiler (``profile_request``, the device's activity alone: the
    torch loop's ~51 operations an iteration would add millions of host
    events). ``main`` profiles fleet_b160 alone (each profiled re-solve
    costs ~30 s of the script's time limit), tools/k4_readings.py --k6
    both."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
    from pyhybridcontrol_tpu_torch.profile_serve import profile_request

    M, N = FLEET_B160
    out = {}
    for par, path, ref_obj in ((False, "fleet_b160", FLEET_B160_REF_OBJ),
                               (True, "fleet_b160_par",
                                FLEET_B160_REF_OBJ_PAR)):
        c, price, x0, (A_v, b_e) = fleet_controller(M, N, dev,
                                                     parallel=par)
        sw = c._sw

        def solve():
            return c.feedback(x0, price_seq=price)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_k5_nor_plain_sweep(), solve_calls() as n:
            r, _ = drive(path, solve)
        sec = time.perf_counter() - t0
        got = PATH_LAUNCHES[path]
        C = cs.any_windows(N) if par else 1
        obj = float(r.obj)
        rel = abs(obj - ref_obj) / max(1.0, abs(ref_obj))
        print(f"{path}: {M} batteries N={N} (b={sw.b}, m={sw.m_k}, "
              f"n_ext={sw.n_ext}; the torch loop with K6, "
              f"{'C=' + str(C) + ' windows' if par else 'sequential'}): "
              f"{sec:.2f} s, found {bool(r.found)}, {int(r.nodes)} nodes, "
              f"{n[0]} relaxations and probes, K6 {got['stagewise_k6']} "
              f"launches (batch sizes {PATH_BATCHES[path]}); objective "
              f"{obj:.6f} (the JAX package on the CPU: {ref_obj:.6f}, "
              f"relative {rel:.2e}, limit 1e-3), u0 "
              f"{r.u.cpu().numpy().tolist()}", flush=True)
        check(bool(r.found), f"{path}: no plan found")
        check(rel <= 1e-3, f"{path}: objective off the JAX package's")
        check(got["stagewise_k6"] > 0 and all(
            v == 0 for k, v in got.items() if k != "stagewise_k6"),
            f"{path}: K6 and nothing else must launch, launches {got}")
        xi = torch.cat([r.v_seq, r.x_seq], dim=1).double().cpu().numpy()
        sw_plan_feasible(f"{path} plan", c.model, x0, xi)
        over = float((A_v @ xi[:, :sw.nv].reshape(-1) - b_e).max())
        print(f"  {path} plan: extra rows max(A_v·V − b) = {over:.2e} "
              f"(limit {FEAS_TOL:g})", flush=True)
        check(over <= FEAS_TOL, f"{path}: the plan breaks an extra row")
        out[path] = dict(M=M, N=N, b=sw.b, windows=C, s=sec,
                         found=bool(r.found), obj=obj, ref_obj=ref_obj,
                         nodes=int(r.nodes), solves=n[0],
                         k6_launches=got["stagewise_k6"],
                         u0=r.u.cpu().numpy().tolist(),
                         extra_rows_over=over)
        if path not in profiled:
            continue
        t0 = time.perf_counter()
        with no_k5_nor_plain_sweep():
            prof = profile_request(solve, cpu=False)
        prof["idle_share"] = 1.0 - prof["device_busy_ms"] / prof["wall_ms"]
        prof["reading_s"] = time.perf_counter() - t0
        print(f"  {path}, the solve again (warm) under torch.profiler "
              f"(device activity; {prof['reading_s']:.1f} s with the "
              f"profiler's start and its events read): "
              f"{prof['wall_ms']:.1f} ms, {prof['device_ops']} device "
              f"operations, busy {prof['device_busy_ms']:.1f} ms: idle share "
              f"{prof['idle_share']:.4f}; K6 {prof['k6_launches']} kernels, "
              f"{prof['k6_device_ms']:.1f} ms on the device", flush=True)
        out[path]["profile"] = prof
    return out


def sw_plan_feasible(tag, model, x0, xi, tol=FEAS_TOL):
    """A single-scenario stagewise plan xi (N, b) in fp64
    (``plan6_feasible`` with one scenario and no disturbance)."""
    import numpy as np

    N = xi.shape[0]
    one = types.SimpleNamespace(
        S=1, N=N, omega_paths=np.zeros((1, N, model.info.nomega)),
        groups=np.zeros((1, N), dtype=int))
    plan6_feasible(tag, model, one, x0, np.asarray(xi)[None], tol=tol)


def fleet_arrays(M, N, nv, tou, Ts_h, window=FLEET_WINDOW):
    """The numpy pieces of an M-battery fleet (shared with
    tools/fleet_reference.py, which builds the same on the JAX package):
    the coupling rows' F1 (2, M) and f5 (2,); the extra rows' A_v
    (n_ext, N·nv) over v stacked by step (p_i,k at k·nv + i) and b
    (n_ext,); price_seq (N, nv) (tou·Ts_h on each p); x0 (M,)."""
    import numpy as np

    rows = []
    for i in range(M):
        a = np.zeros(N * nv)
        a[np.arange(N) * nv + i] = -1.0
        rows.append(a)
    for k0 in range(0, N, window):
        a = np.zeros(N * nv)
        for k in range(k0, min(N, k0 + window)):
            a[k * nv:k * nv + M] = 1.0
        rows.append(a)
    rhs = np.array([FLEET_EXPORT] * M + [FLEET_IMPORT] * (len(rows) - M))
    price = np.zeros((N, nv))
    price[:, :M] = (np.asarray(tou, np.float64) * Ts_h)[:, None]
    return (np.vstack([np.ones(M), -np.ones(M)]), np.full(2, FLEET_FEEDER),
            np.array(rows), rhs, price, np.linspace(0.3, 0.7, M))


def fleet_controller(M, N, dev, window=FLEET_WINDOW, spec=FLEET_SPEC,
                     parallel=False):
    """(built stagewise MpcController, price_seq, x0, (A_v, b)) of an
    M-battery fleet over N steps (``fleet_arrays``); ``parallel``: its
    ``sw_parallel`` twin (the horizon-parallel sweeps)."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.mld.compose import aggregate_mld
    from pyhybridcontrol_tpu_torch.models.battery import (
        BatteryParams, battery_model, battery_weights)
    from pyhybridcontrol_tpu_torch.models.grid import default_tou_profile
    from pyhybridcontrol_tpu_torch.ops.condense import MpcWeights
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    p = BatteryParams()
    one = battery_model(p)
    F1, f5, A_v, b_e, price, x0 = fleet_arrays(
        M, N, M * one.info.nv, default_tou_profile(N), p.Ts_h, window)
    model = aggregate_mld([battery_model(p) for _ in range(M)],
                          coupling_F1=F1, coupling_f5=f5)
    bw = battery_weights()
    w = MpcWeights(Qx=np.tile(bw.Qx, M), x_ref=np.tile(bw.x_ref, M),
                   Ru=np.tile(bw.Ru, M))
    c = MpcController(model, N, w, solver="stagewise",
                      bnb_spec=BnbSpec(**spec), sw_parallel=parallel,
                      device=dev)
    c.set_extra_constraints(A_v, b_e)
    return c.build(), price, x0, (A_v, b_e)


def phase_wide_paths(dev):
    """The paths of K5's FLEX and horizon variants, through the entry
    points a user calls, with the plain loop and sweeps made to raise.
    long_horizon: ``MpcController(..., solver="stagewise").feedback(x0)``
    for the double integrator at N=1000 and the PWA hull model at N=300
    (LONG_SPEC), then each one's ``sw_parallel=True`` twin, one K5 launch
    (horizon: the sequential sweep, the twins' the parallel one) a
    relaxation or probe; each found plan feasible in fp64, each twin's
    objective, found flag and nodes beside its sequential solve's; then
    each again warm, timed and under torch.profiler (``long_warm_reading``:
    device busy time, the idle share against the profiled run's own wall
    time, each K5 launch's iterations, clusters and device time). wide_tree: config 6's long arm at S = 16, 27
    and 64 (WIDE_TREES) through the stagewise tree MIQP with its probe
    prep at ρ·10 (as phase 21), one K5 launch (WIDE_VARIANT) a relaxation
    or probe, at P a multiple of S; u₀'s spread over the scenarios within
    U0_SPREAD, the plan feasible in fp64 with the budget row. Each solve
    prints its found share, nodes, waves and wall time, then is read again
    warm (``long_warm_reading``: K5's launches, iterations and event time,
    the idle share)."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        assemble_stagewise_tree, assemble_stagewise_tree_ext,
        solve_tree_miqp_stagewise)
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    out = {}
    ctrls = {(k, par): long_controller(k, dev, parallel=par)
             for k in ("di", "hull") for par in (False, True)}

    def long_solves():
        res = {}
        for key, c in ctrls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = c.feedback(list(X0_LONG[key[0]]))
            torch.cuda.synchronize()
            res[key] = (r, time.perf_counter() - t0)
        return res

    with no_plain_sweep(), solve_calls() as n_long, k5_calls() as calls:
        res, _ = drive("long_horizon", long_solves)
    only_k5("long_horizon", 1, n_long[0], kernel="stagewise_k5_horizon")
    n_par = sum(bool(kw.get("parallel")) for kw in calls.kw)
    check(0 < n_par < len(calls) == n_long[0],
          f"long_horizon: {n_par} of {len(calls)} K5 calls in the parallel "
          f"sweep, {n_long[0]} solves")
    found = 0
    for (k, par), (r, sec) in res.items():
        c = ctrls[k, par]
        found += bool(r.found)
        name = f"{k}{'_parallel' if par else ''}"
        print(f"long_horizon, {k} N={c.N} (b={c._sw.b}, m={c._sw.m_k}, "
              f"N·nv={c.N * c.model.info.nv})"
              + (", sw_parallel twin" if par else "")
              + f": {sec:.2f} s, found {bool(r.found)}, {int(r.nodes)} "
              f"nodes, obj {float(r.obj):.6f}, u0 "
              f"{r.u.cpu().numpy().tolist()}", flush=True)
        if r.found:
            xi = torch.cat([r.v_seq, r.x_seq], dim=1).double().cpu()
            sw_plan_feasible(f"long_horizon {name} plan", c.model,
                             X0_LONG[k], xi.numpy())
        out[name] = dict(N=c.N, s=sec, found=bool(r.found),
                         obj=float(r.obj), nodes=int(r.nodes))
    for k in ("di", "hull"):
        a, b = out[k], out[k + "_parallel"]
        ref = [("no plan" if v is None else f"{v:.6f}")
               for v in (LONG_REF_OBJ[k], LONG_REF_OBJ_PAR[k])]
        print(f"long_horizon, {k}: sequential obj {a['obj']:.6f}, found "
              f"{a['found']}, {a['nodes']} nodes, {a['s']:.2f} s; the "
              f"sw_parallel twin obj {b['obj']:.6f}, found {b['found']}, "
              f"{b['nodes']} nodes, {b['s']:.2f} s; the JAX package on the "
              f"CPU {ref[0]} (with sw_parallel {ref[1]})", flush=True)
    print(f"long_horizon: found share {found / len(res):.2f} (sequential "
          f"{sum(out[k]['found'] for k in ('di', 'hull')) / 2:.2f}, twins "
          f"{sum(out[k + '_parallel']['found'] for k in ('di', 'hull')) / 2:.2f})",
          flush=True)
    for (k, par), c in ctrls.items():
        name = f"{k}{'_parallel' if par else ''}"
        out[name]["profile"] = long_warm_reading(
            name, lambda: c.feedback(list(X0_LONG[k])))

    x0 = torch.tensor(X0_6, device=dev)
    model = omega_model()
    trees = []
    for S, steps in WIDE_TREES:
        tree = wide_tree(S, steps)
        swt, swtp = config6_preps(dev, tree, config6_extra(CFG6_N))
        trees.append((S, tree, swt, swtp, assemble_stagewise_tree(swt, x0),
                      assemble_stagewise_tree_ext(swt, x0)))

    def tree_solves():
        res = {}
        for S, tree, swt, swtp, data, eu in trees:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = solve_tree_miqp_stagewise(swt, *data, BnbSpec(**WIDE_SPEC),
                                          swt_probe=swtp, ext_u=eu)
            torch.cuda.synchronize()
            res[S] = (r, time.perf_counter() - t0)
        return res

    with no_plain_sweep(), solve_calls() as n_tree:
        res, _ = drive("wide_tree", tree_solves)
    got = PATH_LAUNCHES["wide_tree"]
    kernels = set(WIDE_VARIANT.values())
    check(sum(got[k] for k in kernels) == n_tree[0] > 0
          and all(v == 0 for k, v in got.items() if k not in kernels),
          f"wide_tree: K5 ({sorted(kernels)}) once a relaxation or probe "
          f"({n_tree[0]}) and nothing else must launch, launches {got}")
    for k in kernels:
        check(got[k] > 0, f"wide_tree: {k} never launched")
        sizes = PATH_BATCHES["wide_tree"][k]
        check(all(any(P % S == 0 and P // S <= WIDE_SPEC["wave_size"]
                      for S, *_ in WIDE_TREES if WIDE_VARIANT[S] == k)
                  for P in sizes),
              f"wide_tree: {k} launched at P = {sorted(sizes)}")
    found = 0
    for S, tree, swt, *_ in trees:
        r, sec = res[S]
        found += bool(r.found)
        xi = r.x.reshape(S, CFG6_N, swt.sw.b)
        u0 = xi[:, 0, 0]
        spread = float(u0.max() - u0.min())
        print(f"wide_tree S={S}: {sec:.2f} s, found {bool(r.found)}, "
              f"{int(r.nodes_solved)} nodes, {r.waves} waves, obj "
              f"{float(r.obj):.6f}, u0 {float(u0.mean()):.6f}, spread over "
              f"the scenarios {spread:.2e} (limit {U0_SPREAD:g})", flush=True)
        check(spread < U0_SPREAD, f"wide_tree S={S}: u0 differs over the "
              f"scenarios by {spread:.3e}")
        if r.found:
            plan6_feasible(f"wide_tree S={S} plan", model, tree, X0_6,
                           xi.cpu(), budget=CFG6_BUDGET)
        out[f"tree{S}"] = dict(S=S, s=sec, found=bool(r.found),
                               obj=float(r.obj), waves=r.waves,
                               nodes=int(r.nodes_solved), u0_spread=spread)
    print(f"wide_tree: found share {found / len(trees):.2f}", flush=True)
    for S, tree, swt, swtp, data, eu in trees:
        out[f"tree{S}"]["profile"] = long_warm_reading(
            f"S={S}", lambda: solve_tree_miqp_stagewise(
                swt, *data, BnbSpec(**WIDE_SPEC), swt_probe=swtp, ext_u=eu),
            path="wide_tree")
    wide_tree_twins(model, trees, out)
    return out


def wide_tree_twins(model, trees, out):
    """The wide trees' ``parallel_sweeps=True`` twins (the path
    wide_tree_par): every relaxation and probe one launch of K5's parallel
    sweep in the plan's variant (WIDE_VARIANT's, "_par"), at P a multiple
    of S; each found as its sequential solve (``out``), its objective
    within 1e-3 of that solve's, u₀'s spread over the scenarios within
    U0_SPREAD, the plan feasible in fp64 with the budget row; then each
    read again warm (``long_warm_reading``)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        solve_tree_miqp_stagewise)
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    def twin(swt, swtp, data, eu):
        return solve_tree_miqp_stagewise(swt, *data, BnbSpec(**WIDE_SPEC),
                                         swt_probe=swtp, ext_u=eu,
                                         parallel_sweeps=True)

    def tree_solves():
        res = {}
        for S, tree, swt, swtp, data, eu in trees:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = twin(swt, swtp, data, eu)
            torch.cuda.synchronize()
            res[S] = (r, time.perf_counter() - t0)
        return res

    with no_plain_sweep(), solve_calls() as n, k5_calls() as calls:
        res, _ = drive("wide_tree_par", tree_solves)
    got = PATH_LAUNCHES["wide_tree_par"]
    kernels = {v + cs.PAR_SUFFIX for v in WIDE_VARIANT.values()}
    check(sum(got[k] for k in kernels) == n[0] > 0
          and all(v == 0 for k, v in got.items() if k not in kernels)
          and all(kw.get("parallel") for kw in calls.kw),
          f"wide_tree_par: K5's parallel sweep ({sorted(kernels)}) once a "
          f"relaxation or probe ({n[0]}) and nothing else must launch, "
          f"launches {got}")
    for S, tree, swt, *_ in trees:
        r, sec = res[S]
        a = out[f"tree{S}"]
        xi = r.x.reshape(S, CFG6_N, swt.sw.b)
        u0 = xi[:, 0, 0]
        spread = float(u0.max() - u0.min())
        obj = float(r.obj)
        rel = abs(obj - a["obj"]) / max(1.0, abs(a["obj"]))
        wins = sorted({k5_plan_of(c, parallel=True)[1].windows
                       for c in calls if c[0] is swt.sw})
        print(f"wide_tree S={S}, the parallel_sweeps twin ({wins} windows "
              f"a problem): {sec:.2f} s (sequential {a['s']:.2f} s), found "
              f"{bool(r.found)}, {int(r.nodes_solved)} nodes, {r.waves} "
              f"waves, obj {obj:.6f} against the sequential solve's "
              f"{a['obj']:.6f} (relative {rel:.2e}, limit 1e-3), u0 spread "
              f"over the scenarios {spread:.2e} (limit {U0_SPREAD:g})",
              flush=True)
        check(bool(r.found) == a["found"] and rel <= 1e-3
              and spread < U0_SPREAD,
              f"wide_tree S={S} twin: off its sequential solve")
        if r.found:
            plan6_feasible(f"wide_tree S={S} twin plan", model, tree, X0_6,
                           xi.cpu(), budget=CFG6_BUDGET)
        out[f"tree{S}_parallel"] = dict(
            S=S, s=sec, found=bool(r.found), obj=obj, waves=r.waves,
            nodes=int(r.nodes_solved), u0_spread=spread, windows=wins)
    for S, tree, swt, swtp, data, eu in trees:
        out[f"tree{S}_parallel"]["profile"] = long_warm_reading(
            f"S={S}, the parallel_sweeps twin",
            lambda: twin(swt, swtp, data, eu), path="wide_tree_par")


# ---- the user-facing surfaces ----------------------------------------------

# the micro-grid coordinator of agents/micro_grid.py at its own horizon,
# with the example's spec (examples/micro_grid_study.py) and room for all
# heaters but one, so the coupling binds: (agents, steps) of each run
MG_N = 24
MG_SPEC = dict(capacity=256, wave_size=32, qp_iters=200)
MG_RUNS = ((3, 4), (4, 2))
# each visited state's objective is held against the fp64 oracle at this
# reduced horizon (the 216-288 binaries of N=24 are out of its reach)
MG_ORACLE_N = 2
# B&B (fp32 ADMM, 200 iterations a node, its absolute gap 1e-4) against
# the fp64 optimum: relative, floor 1
MG_ORACLE_REL = 1e-3
# the decentralized micro-grid: agents at its own N=8 and spec, room for
# half of the heaters, and its steps
DEC_M, DEC_STEPS = 8, 3
K2_VARIANTS = ("admm_k2", "admm_k2_resident", "admm_k2_streamed")
# config 5 (run --config sharded_bnb): 512 instances of N=20 pooled, a
# global wave of 512 × 64 nodes, 300 + 300 iterations a wave
CFG5_WAVE = 512 * 64


def microgrid(M, N, dev):
    """The coordinator of M default DEWH agents at horizon N on ``dev``:
    the TOU tariff, P_max = (M−1)·3 kW, the example's spec."""
    from pyhybridcontrol_tpu_torch.agents.micro_grid import (
        MicroGridCoordinator)
    from pyhybridcontrol_tpu_torch.models.dewh import DewhParams
    from pyhybridcontrol_tpu_torch.models.grid import (
        GridParams, default_tou_profile)
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    grid = GridParams(P_max=(M - 1) * 3000.0,
                      tou_prices=default_tou_profile())
    return MicroGridCoordinator([DewhParams() for _ in range(M)], grid,
                                N=N, solver="bnb",
                                bnb_spec=BnbSpec(**MG_SPEC), device=dev)


def surface_problem(name, B, dev, rng, fix_frac=0.3):
    """Node problems of a surface path's frame at B seeded states, as
    ``real_problem`` returns them (prepared specs at ρ and at the probe's
    ρ, or None where the path's probe runs at ρ; binary indices; f, h;
    node boxes fixing ``fix_frac`` of the binaries):
    "microgrid_M3"/"microgrid_M4", the coordinator's aggregate frame
    (N=24, soft comfort bands; each heater at 50–62 °C with a seeded
    binary state, the tariff from step 0); "decentralized", the agents'
    shared DEWH frame (N=8, soft comfort band; per-agent prices with a
    seeded congestion price); "config5", the double integrator at N=20."""
    import numpy as np
    import torch

    if name == "config5":
        _, qp, spec, spec_p, f, h, lb, ub = problem(20, B, dev, rng,
                                                    fix_frac)
        return spec, spec_p, qp.binary_idx, f, h, lb, ub
    if name == "decentralized":
        from pyhybridcontrol_tpu_torch.agents.decentralized import (
            DecentralizedMicroGrid)
        from pyhybridcontrol_tpu_torch.models.dewh import DewhParams

        d = DecentralizedMicroGrid([DewhParams()] * 2, device=dev)
        qp, spec, spec_p = d.qp, d.admm, None
        x0s = np.stack([rng.uniform(50.0, 62.0, B), rng.integers(0, 2, B)],
                       axis=1)
        prices = np.zeros((B, d.N, qp.info.nv))
        prices[:, :, 0] = rng.uniform(0.0, 1.5, (B, d.N))
    else:
        M = int(name[-1])
        mg = microgrid(M, MG_N, dev)
        qp, spec, spec_p = (mg.controller.device_qp, mg.controller.admm,
                            mg.controller.admm_probe)
        x0s = np.concatenate([np.stack([rng.uniform(50.0, 62.0, B),
                                        rng.integers(0, 2, B)], axis=1)
                              for _ in range(M)], axis=1)
        prices = mg.price_seq()
    x0s, prices = on_card(dev, x0s.astype(np.float32),
                          prices.astype(np.float32))
    f, h = qp.assemble(x0s, None, None, prices)
    lb, ub = node_boxes(qp, B, rng, fix_frac)
    return spec, spec_p, qp.binary_idx, f, h, lb, ub


# (name, wave, iterations, probe iterations, the plan's variant, limits,
# flip share, certificate band); the micro-grid probes are stiff (ρ·10
# then ρ), the decentralized ones at ρ
SURFACE_SHAPES = (
    ("microgrid_M4", 32, 200, 200, "streamed", "microgrid", FLIP_SHARE,
     CERT_BAND),
    ("microgrid_M3", 32, 200, 200, "resident", "microgrid", FLIP_SHARE,
     CERT_BAND),
    ("decentralized", DEC_M * 16, 200, 200, "staged", "surfaces",
     FLIP_SHARE_DEC, CERT_BAND_DEC),
    ("config5", CFG5_WAVE, 300, 300, "staged", "surfaces", FLIP_SHARE,
     CERT_BAND))


def phase_surface_shapes(dev, rng, recs):
    """K2 at the waves the surfaces' paths give it, warm-started as every
    wave after the root is, each against its plain version on node
    problems of its frame ("microgrid" limits on the micro-grid frames'
    relaxation and probe, "surfaces" on the others; certificate bits may
    differ near a threshold on the DEWH frames, CERT_BAND_DEC and
    FLIP_SHARE_DEC on the decentralized wave): the 4-agent micro-grid
    (N=24: 480/888, where a cluster cannot hold the constants, so the plan
    streams them from L2), the 3-agent one
    (360/672, resident over 16 CTAs; bitwise against the L2-streamed
    variant at the same tile too), a dual round of the decentralized
    agents (8 × a wave of 16, staged) and config 5's global wave (512 × 64
    nodes of N=20, 300 + 300 iterations, staged). Each with its plan and,
    with TIMINGS, its times beside the bound."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    print("K2 at the surfaces' waves:", flush=True)
    for name, B, iters, piters, variant, regime, flips, band in \
            SURFACE_SHAPES:
        spec, spec_p, bidx, q, h, lb, ub = surface_problem(name, B, dev, rng)
        kq = ca.kernel_qp_for(spec)
        kq2 = None if spec_p is None else ca.kernel_qp_for(spec_p)
        pl = ca.plan(B, kq.n_pad, kq.m_pad)
        got_variant = ("streamed" if pl.streamed else
                       "resident" if pl.cluster > 1 else "staged")
        print(f"  plan {name} (padded {kq.n_pad}/{kq.m_pad}) B={B}: {pl}",
              flush=True)
        check(got_variant == variant, f"{name}: the plan picks the "
              f"{got_variant} variant, not the {variant} one")
        key = {"staged": "admm_k2", "resident": "admm_k2_resident",
               "streamed": "admm_k2_streamed"}[variant]
        rec = recs[key]
        rec[f"{name}_B{B}_plan"] = dict(pb=pl.pb, cluster=pl.cluster,
                                        threads=pl.threads, smem=pl.smem)
        wargs = (kq, kq2, bidx, q, h, lb, ub)
        kw = dict(iters=iters, probe_iters=piters)
        cold = ca.admm_wave_plain(*wargs, **kw)
        warm = (cold[0].x, cold[0].z, cold[0].y)
        tag = f"K2 {name} B={B} {iters}+{piters} it warm"
        got = ca.admm_wave_cuda(*wargs, warm=warm, **kw)
        with cert_band(band):
            compare_probe(tag, got,
                          ca.admm_wave_plain(*wargs, warm=warm, **kw),
                          types.SimpleNamespace(binary_idx=bidx), lb, ub,
                          rec, regime, flip_share=flips,
                          plain=(None if name == "config5"
                                 else (kq, q, h, lb, ub)))
        if variant == "resident":
            forced = l2(kq, pl)
            st = ca.admm_wave_cuda(*wargs, warm=warm, **forced, **kw)
            held_bitwise("relaxation " + tag, got[0], st[0])
            held_bitwise("probe " + tag, got[1], st[1])
        if not TIMINGS:
            continue
        timed(rec, f"{name}_B{B}_wave_",
              lambda: ca.admm_wave_cuda(*wargs, warm=warm, **kw),
              lambda: ca.admm_wave_plain(*wargs, warm=warm, **kw),
              admm_work(kq.n_pad, kq.m_pad, B, products=iters + piters + 2,
                        stats=2, warm=True, stiff=kq2 is not None,
                        outputs=2))


def run_cli(path, argv, dev):
    """``run_cli_inner(argv, dev)`` as the driven path ``path``; its wall
    time printed."""
    t0 = time.perf_counter()
    line, _ = drive(path, lambda: run_cli_inner(argv, dev))
    print(f"  ({time.perf_counter() - t0:.2f} s)", flush=True)
    return line


def phase_run_cli(dev):
    """``python -m pyhybridcontrol_tpu_torch.run`` in process through
    ``main(argv)`` on the card, at full width: config 1 at its T=40 with
    ``--log`` (one JSONL record a step, read back); config 3 (move
    blocking, soft band, min-up rows) for 8 steps; config 2 (hull, N=20)
    for 3; configs 4 (B=1024) and 5 (B=512, N=20: a global wave of 32,768
    nodes and a pool of 524,288) as one pooled batch each, every K2 launch
    at the global wave; then config 1 for 6 steps in chunks of 2 with
    snapshots, within rtol 1e-4 of the unchunked 6-step study (the
    reference test's bound, tests/test_cli.py), resumed to 8 steps
    (resumed_from 6) and resumed again (a no-op). Every line's found
    share is 1.0."""
    import tempfile

    import numpy as np

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        log = str(Path(tmp) / "run.jsonl")
        r1 = run_cli("run_config1", ["--config", "double_integrator",
                                     "--log", log], dev)
        recs = [json.loads(s) for s in open(log)]
        check([r["step"] for r in recs] == list(range(40)),
              f"run --log: {len(recs)} records for 40 steps")
        tot = sum(r["obj"] for r in recs)
        check(abs(tot - r1["total_cost"]) <= 1e-5 * abs(tot),
              f"run --log: the records sum to {tot}, the line says "
              f"{r1['total_cost']}")
        print(f"  --log: {len(recs)} records read back, objectives sum to "
              f"{tot:.4f}", flush=True)
        out["config1"] = r1
        out["config3"] = run_cli("run_config3", ["--config", "thermal_uc",
                                                 "--steps", "8"], dev)
        out["config2"] = run_cli("run_config2", ["--config", "pwa_actuator",
                                                 "--steps", "3"], dev)
        out["config4"] = run_cli("run_config4", ["--config",
                                                 "scenario_batch"], dev)
        launched_at("run_config4", K2_VARIANTS, 1024 * 16)
        out["config5"] = r5 = run_cli("run_config5", ["--config",
                                                      "sharded_bnb"], dev)
        launched_at("run_config5", K2_VARIANTS, CFG5_WAVE)
        check((r5["batch"], r5["global_wave"], r5["pool_slots"])
              == (512, CFG5_WAVE, 512 * 1024),
              f"config 5: batch, wave and pool {r5}")
        print(f"  config 5: pool of {r5['pool_slots']} nodes, "
              f"{r5['pool_bytes'] / 2**30:.3f} GiB", flush=True)
        for k, r in out.items():
            check(r["found_frac"] == 1.0, f"run {k}: found share "
                  f"{r['found_frac']}")
            check(PATH_LAUNCHES[f"run_{k}"]["admm_k2"]
                  + PATH_LAUNCHES[f"run_{k}"]["admm_k2_resident"] > 0,
                  f"run {k}: K2 was never launched")
        ckpt = str(Path(tmp) / "study.ckpt")
        base = ["--config", "double_integrator"]
        chunk = ["--checkpoint", ckpt, "--checkpoint-every", "2"]

        def study():
            return [run_cli_inner(base + ["--steps", "6"], dev),
                    run_cli_inner(base + ["--steps", "6"] + chunk, dev),
                    run_cli_inner(base + ["--steps", "8", "--resume"]
                                  + chunk, dev),
                    run_cli_inner(base + ["--steps", "8", "--resume"]
                                  + chunk, dev)]

        (plain, got, res, again), _ = drive("run_checkpoint_resume", study)
    rel = abs(got["total_cost"] - plain["total_cost"]) / abs(
        plain["total_cost"])
    print(f"  chunked total cost {got['total_cost']:.6f}, unchunked "
          f"{plain['total_cost']:.6f} (rel {rel:.2e}, limit 1e-4); resumed "
          f"from {res['resumed_from']} for {res['steps']} steps; again: "
          f"{again}", flush=True)
    check(got["resumed_from"] == 0 and got["steps"] == 6,
          f"chunked study: {got}")
    check(rel <= 1e-4, f"chunked study: total cost rel {rel:.3e} off the "
          "unchunked one")
    check(res["resumed_from"] == 6 and res["steps"] == 2
          and res["found_frac"] == 1.0 and np.isfinite(res["total_cost"]),
          f"resumed study: {res}")
    check(again["steps"] == 0 and again["resumed_from"] == 8,
          f"finished study resumed: {again}")
    out["checkpoint_resume"] = dict(chunked=got, unchunked=plain,
                                    resumed=res)
    return out


def run_cli_inner(argv, dev):
    """``run.main(argv)`` in process on ``dev``: its JSON line, printed
    and parsed."""
    from pyhybridcontrol_tpu_torch import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(argv + ["--device", dev.type])
    check(rc == 0, f"run {' '.join(argv)}: exit code {rc}")
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"  run {' '.join(argv)}: {line}", flush=True)
    return json.loads(line)


@contextlib.contextmanager
def bnb_plans(log):
    """Every ``solve_miqp_bnb`` the controller runs appends its result's
    decision vector to ``log`` (host fp64)."""
    from pyhybridcontrol_tpu_torch.control import mpc

    orig = mpc.solve_miqp_bnb

    def rec(*a, **kw):
        res = orig(*a, **kw)
        log.append(res.x.double().cpu().numpy())
        return res

    mpc.solve_miqp_bnb = rec
    try:
        yield log
    finally:
        mpc.solve_miqp_bnb = orig


def k2_variant(path):
    return [k for k in K2_VARIANTS if PATH_LAUNCHES[path][k]]


def phase_micro_grid(dev):
    """The micro-grid coordinator (agents/micro_grid.py) at its own N=24
    with the example's spec, P_max = (M−1)·3 kW: 3 agents for 4 steps
    (aggregate frame 360/672, 216 binaries: resident K2), then 4 for 2
    (480/888, 288 binaries: the L2-streamed K2), from 52+i °C with seeded
    draws. Each step's applied total power within P_max; each plan
    feasible in fp64 (FEAS_TOL) on the controller's frame; each visited
    state's objective at N=MG_ORACLE_N (the coordinator at that horizon
    on the card) within MG_ORACLE_REL of the port's fp64 oracle; the K2
    variant that ran, per M."""
    import numpy as np

    out = {}
    for M, steps in MG_RUNS:
        path = f"microgrid_M{M}"
        mg = microgrid(M, MG_N, dev)
        mg.reset([np.array([52.0 + i, 0.0]) for i in range(M)])
        rng = phase_rng(path)
        draws = (rng.uniform(0, 1, (steps, M)) < 0.2) * 0.5
        visited, sols, Vs = [], [], []

        def run_steps():
            for k in range(steps):
                visited.append((mg.x.double().cpu().numpy(), mg.price_seq(),
                                mg.k))
                sols.append(mg.sim_step(omega_k=draws[k]))

        t0 = time.perf_counter()
        with bnb_plans(Vs):
            drive(path, run_steps)
        wall = time.perf_counter() - t0
        P_max = mg.grid.P_max
        powers = [s.total_power for s in sols]
        print(f"  {M} agents, N={MG_N}, {steps} steps: {wall:.2f} s "
              f"({1e3 * wall / steps:.0f} ms a step), total power "
              f"{powers} W (P_max {P_max:.0f}), objectives "
              f"{[round(float(s.obj), 4) for s in sols]}, K2 variant "
              f"{k2_variant(path)}", flush=True)
        check(all(p <= P_max for p in powers), f"{path}: coupling "
              f"violated: {powers}")
        check(all(bool(s.found) for s in sols), f"{path}: a step without "
              "a plan")
        want = "admm_k2_streamed" if M == 4 else "admm_k2_resident"
        check(k2_variant(path) == [want], f"{path}: K2 ran as "
              f"{k2_variant(path)}, not {want}")
        c = mg.controller.condensed
        plans_feasible(f"{path} plans", c,
                       [(V, x, None, P) for V, (x, P, _) in zip(Vs, visited)])
        # the objective at the reduced horizon against the fp64 oracle
        small = microgrid(M, MG_ORACLE_N, dev)
        cs = small.controller.condensed
        d, refs = [], []
        for x, _, k in visited:
            small.reset(x.reshape(M, 2))
            small.k = k
            sol = small.feedback()
            P = small.price_seq()
            orc, nodes = oracle_bnb(cs, *cs.assemble_np(x, price_seq=P))
            d.append(abs(float(sol.obj) - orc) / max(1.0, abs(orc)))
            refs.append(orc)
            print(f"  {M} agents at N={MG_ORACLE_N} "
                  f"({len(cs.binary_idx)} binaries), step {k}: B&B "
                  f"{float(sol.obj):.5f}, fp64 oracle {orc:.5f} ({nodes} "
                  f"nodes)", flush=True)
        print(f"  {path}: B&B vs fp64 oracle at N={MG_ORACLE_N}, worst "
              f"relative {max(d):.2e} (limit {MG_ORACLE_REL:.0e})",
              flush=True)
        check(max(d) <= MG_ORACLE_REL, f"{path}: B&B {max(d):.3e} off the "
              "fp64 oracle")
        out[path] = dict(s_per_step=wall / steps, total_power=powers,
                         objs=[float(s.obj) for s in sols],
                         k2=k2_variant(path), oracle_rel=max(d))
    return out


def phase_decentralized(dev):
    """The decentralized micro-grid (agents/decentralized.py): DEC_M
    agents at its own N=8 and spec, from 50+0.2·i °C, room for half of
    the heaters, DEC_STEPS steps with seeded draws. Every dual round is
    one pooled B&B over all agents: each K2 launch over the global wave
    of DEC_M × 16 nodes (``launched_at``); after rationing the coupling
    holds; λ printed."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.agents.decentralized import (
        DecentralizedMicroGrid)
    from pyhybridcontrol_tpu_torch.models.dewh import DewhParams
    from pyhybridcontrol_tpu_torch.models.grid import (
        GridParams, default_tou_profile)

    grid = GridParams(P_max=DEC_M // 2 * 3000.0,
                      tou_prices=default_tou_profile())
    dmg = DecentralizedMicroGrid([DewhParams() for _ in range(DEC_M)], grid,
                                 device=dev)
    dmg.reset([np.array([50.0 + 0.2 * i, 0.0]) for i in range(DEC_M)])
    rng = phase_rng("decentralized")
    draws = (rng.uniform(0, 1, (DEC_STEPS, DEC_M)) < 0.2) * 0.3
    t0 = time.perf_counter()
    sols, _ = drive("decentralized", lambda: [dmg.sim_step(omega_k=w)
                                              for w in draws])
    wall = time.perf_counter() - t0
    for k, s in enumerate(sols):
        print(f"  step {k}: u {s.u.astype(int).tolist()}, power "
              f"{s.agg_power:.0f} W (P_max {grid.P_max:.0f}), λ "
              f"{np.round(s.lam, 4).tolist()}", flush=True)
        check(s.agg_power <= grid.P_max + 1e-6, f"decentralized step {k}: "
              f"coupling violated after rationing ({s.agg_power})")
        check(s.found, f"decentralized step {k}: an agent without a plan")
    W = DEC_M * dmg.bnb_spec.wave_size
    launched_at("decentralized", K2_VARIANTS, W)
    check(sum(PATH_LAUNCHES["decentralized"][k] for k in K2_VARIANTS) > 0,
          "decentralized: K2 was never launched")
    print(f"  {DEC_M} agents, {DEC_STEPS} steps: {wall:.2f} s; every K2 "
          f"launch over all {DEC_M} agents' wave (B={W}): "
          f"{PATH_BATCHES['decentralized']}", flush=True)
    return dict(s_per_step=wall / DEC_STEPS,
                lam=[s.lam.tolist() for s in sols],
                power=[s.agg_power for s in sols])


EXAMPLE_ARGS = {
    "double_integrator_study": ["--steps", "8"],
    "dewh_dsm_study": ["--hours", "3"],
    "micro_grid_study": ["--steps", "3", "--agents", "2"],
    "scenario_tree_study": ["--scenarios", "2", "--horizon", "4"],
    "pwa_formulation_study": ["--N", "6", "--waves", "6"],
}
EXAMPLE_MARKS = {
    "double_integrator_study": "all steps solved: True",
    "dewh_dsm_study": "all MIQPs solved: True",
    "micro_grid_study": "agent 0 history",
    "scenario_tree_study": "study ok: True",
    "pwa_formulation_study": "hull <= bigm: True",
}


def phase_examples(dev):
    """Each of the five examples' ``main`` on the card at small arguments
    (those of tests/test_examples.py), its closing line checked."""
    import importlib

    def all_examples():
        for name, args in EXAMPLE_ARGS.items():
            mod = importlib.import_module(
                f"pyhybridcontrol_tpu_torch.examples.{name}")
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mod.main(args + ["--device", dev.type])
            text = buf.getvalue()
            last = text.strip().splitlines()[-1]
            print(f"  {name} {' '.join(args)}: {time.perf_counter() - t0:.2f}"
                  f" s, ...{last}", flush=True)
            check(EXAMPLE_MARKS[name] in text, f"{name}: "
                  f"'{EXAMPLE_MARKS[name]}' not in its output:\n{text}")

    drive("examples", all_examples)


# ---- multi-device: the world of ranks on the card (parallel/) -------------

MD_WORLD = 8            # ranks of the phase's world; one card, so gloo
MD_TIMEOUT = 420.0      # s: the world's limit and its collectives'
# config 5 of scripts/config5_pool4096.py: the PWA spring (on/off, big-M),
# N=14, 42 binaries, from [1.5, 0], repair-seeded; 8 ranks × 512 slots,
# wave 256, 40 waves, 300 iterations, warm starts; held against one card
# at capacity 4096, wave 256
MD_CFG5_N, MD_CFG5_X0 = 14, (1.5, 0.0)
MD_CFG5_SPEC = dict(capacity=512, wave_size=256, max_waves=40, qp_iters=300)
MD_CFG5_SINGLE = dict(capacity=4096, wave_size=256, max_waves=40,
                      qp_iters=300)
MD_CFG5_JAX_CPU = 79.5026   # that script's docstring: JAX, 8 CPU devices
# the N=10 double integrator at P=2 and 4 (capacity and wave per rank),
# held against one card at P × the capacity
MD_DI_N = 10
MD_DI_SPEC = dict(capacity=128, wave_size=32, max_waves=48, qp_iters=200)
MD_DI_GAP = dict(MD_DI_SPEC, max_waves=64, rel_gap=1e-6, probe_patience=2)
# feedback_batch(mesh=) at config 5's batch: 512 states of the N=20 double
# integrator over 4 ranks, config 5's spec, the pooled engine on each slice
MD_FB_B, MD_FB_N, MD_FB_P = 512, 20, 4
MD_FB_SPEC = dict(capacity=1024, wave_size=64, max_waves=64, qp_iters=300)
# the consensus tree of phase "tree hold" (S=4, N=6), the search capped at
# 4 waves of 300 + 600 iterations: every ADMM iteration of a split tree is
# one all_reduce through the host, ~5 ms with 4 ranks on one H100 (8 waves
# of 600 + 1500 took 177 s at P=2 and 4 there; PERF.md)
MD_TREE_SPEC = dict(capacity=256, wave_size=32, max_waves=4, qp_iters=300,
                    probe_iters=600)
# config 6's long arm over 2 ranks, its B&B capped at 3 of the arm's 6
# waves (one host-staged all_reduce an ADMM iteration, 2–5 ms with two
# ranks on one H100); the single-card K5 reference takes the same cap
MD_CFG6_SPEC = dict(CFG6_SPEC, max_waves=3)
K1_VARIANTS = ("admm_k1", "admm_k1_resident", "admm_k1_streamed",
               "admm_k1_split")


def md_bnb(r):
    """A BnbResult's fields as host values."""
    return dict(obj=float(r.obj), found=bool(r.found),
                nodes=int(r.nodes_solved), waves=int(r.waves),
                overflow=bool(r.overflow), bound=float(r.best_open_bound),
                x=r.x.cpu().numpy())


def md_di(dev):
    """(qp, admm, f, h at [2, 0], f, h at the out-of-box [12, 0]) of the
    N=10 double integrator."""
    import torch

    from pyhybridcontrol_tpu_torch.models import (
        di_default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc

    c = CondensedMpc(switched_double_integrator(), MD_DI_N,
                     di_default_weights())
    qp, admm = c.device_qp(dev), prepare_admm_mpc(c, device=dev)
    return (qp, admm, *qp.assemble(torch.tensor(STATES[0], device=dev)),
            *qp.assemble(torch.tensor(OUT_OF_BOX, device=dev)))


def md_cfg5(dev):
    """(qp, admm, f, h, repair seed) of config 5 at [1.5, 0]."""
    import torch

    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu_torch.solver.repair import (
        prepare_repair, root_repair_incumbent)

    model, w, c = bench_frame("config5")
    qp, admm = c.device_qp(dev), prepare_admm_mpc(c, device=dev)
    x0 = torch.tensor(MD_CFG5_X0, device=dev)
    f, h = qp.assemble(x0)
    seed = root_repair_incumbent(admm, qp, prepare_repair(model, w,
                                                          device=dev),
                                 x0, f, h, qp_iters=300)
    return qp, admm, f, h, seed


def md_tree():
    """Phase "tree hold"'s consensus fixture: S=4, N=6, branching at 1, 3."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.ops.scenario_tree import ScenarioTree

    return ScenarioTree.from_branching(
        np.random.default_rng(3).normal(0.0, 0.3, size=(4, 6, 1)),
        branch_steps=(1, 3))


def md_tree_controller(dev, scen_mesh=None):
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.models import di_default_weights
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    ct = MpcController(omega_model(), 6, di_default_weights(),
                       bnb_spec=BnbSpec(**MD_TREE_SPEC), qp_iters=600,
                       device=dev)
    ct.set_scenario_tree(md_tree(), consensus=True, scen_mesh=scen_mesh)
    return ct.build()


def md_fb_controller(dev):
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.models import (
        di_default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    return MpcController(switched_double_integrator(), MD_FB_N,
                         di_default_weights(),
                         bnb_spec=BnbSpec(**MD_FB_SPEC), device=dev).build()


def md_cfg6(dev):
    """(swt, swt_probe, (q, l, u), ext_u) of config 6's long arm."""
    import torch

    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        assemble_stagewise_tree, assemble_stagewise_tree_ext)

    swt, swtp = config6_preps(dev, config6_trees()[1],
                              config6_extra(CFG6_N))
    x0 = torch.tensor(X0_6, device=dev)
    return (swt, swtp, assemble_stagewise_tree(swt, x0),
            assemble_stagewise_tree_ext(swt, x0))


def md_rank_body(x0s_fb):
    """One rank of the multi-device phase's world (every rank runs the
    same code; sub-meshes of the first 2, 4 or 8 ranks). Per path: its
    result, its wall time on this rank, its launch counts and batch sizes
    (set to 0 just before the path and read just after) and its
    collectives' calls, bytes and seconds."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.ops.condense_scan import (
        condense_horizon_sharded)
    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        solve_tree_miqp_stagewise)
    from pyhybridcontrol_tpu_torch.parallel import (
        STATS, in_mesh, make_mesh, reset_stats)
    from pyhybridcontrol_tpu_torch.parallel.mesh import mesh_backend
    from pyhybridcontrol_tpu_torch.parallel.sharded_bnb import (
        solve_miqp_bnb_sharded)
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    dev = torch.device("cuda", torch.cuda.current_device())
    pool = {P: make_mesh([("pool", P)]) for P in (2, 4, MD_WORLD)}
    scen = {P: make_mesh([("scen", P)]) for P in (2, 4)}
    hz = make_mesh([("hz", 4)])
    out = {"rank": dist.get_rank(), "backend": mesh_backend(pool[2]),
           "paths": {}}

    def path(name, mesh, fn):
        if not in_mesh(mesh):
            return
        torch.cuda.synchronize()
        ca.reset_launch_counts()
        reset_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["paths"][name] = dict(
            res=res, wall=time.perf_counter() - t0,
            launches=dict(ca.LAUNCHES),
            batches={k: dict(v) for k, v in ca.LAUNCH_BATCHES.items() if v},
            stats=dict(STATS), size=mesh.size())

    qp, admm, f, h, seed = md_cfg5(dev)
    path("md_config5_pool", pool[MD_WORLD], lambda: md_bnb(
        solve_miqp_bnb_sharded(admm, qp, f, h, BnbSpec(**MD_CFG5_SPEC),
                               pool[MD_WORLD], init_incumbent=seed)))
    if not in_mesh(pool[4]):
        return out
    qp, admm, f, h, f_out, h_out = md_di(dev)

    def di_cases():
        res = {}
        for P in (2, 4):
            if in_mesh(pool[P]):
                res[f"p{P}"] = md_bnb(solve_miqp_bnb_sharded(
                    admm, qp, f, h, BnbSpec(**MD_DI_SPEC), pool[P]))
        if in_mesh(pool[2]):
            res["out_of_box"] = md_bnb(solve_miqp_bnb_sharded(
                admm, qp, f_out, h_out, BnbSpec(**MD_DI_SPEC), pool[2]))
        res["rel_gap"] = md_bnb(solve_miqp_bnb_sharded(
            admm, qp, f, h, BnbSpec(**MD_DI_GAP), pool[4]))
        return res

    path("md_di_pool", pool[4], di_cases)
    ctrl = md_fb_controller(dev)
    path("md_feedback_batch", scen[MD_FB_P], lambda: {
        k: v.cpu().numpy() for k, v in ctrl.feedback_batch(
            x0s_fb, mesh=scen[MD_FB_P]).items()
        if k in ("obj", "found", "u")})
    path("md_condense", hz, lambda: [t.cpu().numpy() for t in
                                     condense_horizon_sharded(
                                         omega_model().to(dev), CFG6_N, hz)])
    trees = {P: md_tree_controller(dev, (scen[P], "scen"))
             for P in (2, 4) if in_mesh(scen[P])}

    def tree_cases():
        res = {}
        for P, ct in trees.items():
            r = ct.feedback(list(X0_6))
            res[f"p{P}"] = dict(obj=float(r.obj), found=bool(r.found),
                                u=r.u.cpu().numpy(), nodes=int(r.nodes))
        return res

    path("md_consensus_tree", scen[4], tree_cases)
    if in_mesh(scen[2]):
        swt, swtp, data, eu = md_cfg6(dev)
        path("md_stagewise_tree", scen[2], lambda: md_bnb(
            solve_tree_miqp_stagewise(swt, *data, BnbSpec(**MD_CFG6_SPEC),
                                      swt_probe=swtp, ext_u=eu,
                                      scen_mesh=(scen[2], "scen"))))
        path("md_stagewise_tree_par", scen[2], lambda: md_bnb(
            solve_tree_miqp_stagewise(swt, *data, BnbSpec(**MD_CFG6_SPEC),
                                      swt_probe=swtp, ext_u=eu,
                                      scen_mesh=(scen[2], "scen"),
                                      parallel_sweeps=True)))
    return out


def md_nccl_body():
    """A world of one rank on its own card: NCCL. The sharded B&B over a
    one-rank mesh is the unsharded loop, bitwise."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.parallel import (
        STATS, make_mesh, reset_stats)
    from pyhybridcontrol_tpu_torch.parallel.mesh import mesh_backend
    from pyhybridcontrol_tpu_torch.parallel.sharded_bnb import (
        solve_miqp_bnb_sharded)
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec, solve_miqp_bnb

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh([("pool", 1)])
    qp, admm, f, h, _, _ = md_di(dev)
    torch.cuda.synchronize()
    ca.reset_launch_counts()
    reset_stats()
    t0 = time.perf_counter()
    r = solve_miqp_bnb_sharded(admm, qp, f, h, BnbSpec(**MD_DI_SPEC), mesh)
    torch.cuda.synchronize()
    path = dict(res=md_bnb(r), wall=time.perf_counter() - t0,
                launches=dict(ca.LAUNCHES),
                batches={k: dict(v) for k, v in ca.LAUNCH_BATCHES.items()
                         if v},
                stats=dict(STATS), size=1)
    plain = md_bnb(solve_miqp_bnb(admm, qp, f, h, BnbSpec(**MD_DI_SPEC)))
    return dict(backend=mesh_backend(mesh), paths={"md_nccl": path},
                plain=plain)


def md_record(name, ranks):
    """The path's launch counts and batch sizes summed over its ranks into
    PATH_LAUNCHES / PATH_BATCHES; prints the path's line. Returns the
    ranks' path records."""
    recs = [r["paths"][name] for r in ranks if name in r["paths"]]
    check(len(recs) == recs[0]["size"], f"{name}: {len(recs)} ranks "
          f"reported, the mesh has {recs[0]['size']}")
    PATH_LAUNCHES[name] = {k: sum(p["launches"][k] for p in recs)
                           for k in recs[0]["launches"]}
    batches = {}
    for p in recs:
        for k, v in p["batches"].items():
            for b, n in v.items():
                batches.setdefault(k, {})
                batches[k][b] = batches[k].get(b, 0) + n
    PATH_BATCHES[name] = batches

    def per_rank(kernels):
        return [sum(p["launches"][k] for k in kernels) for p in recs]

    res = recs[0]["res"]
    waves = res.get("waves") if isinstance(res, dict) else None
    st = recs[0]["stats"]
    wall = max(p["wall"] for p in recs)
    line = (f"  {name}: {len(recs)} ranks, {wall:.2f} s; "
            f"K1 {per_rank(K1_VARIANTS)}, "
            f"K2 {per_rank(K2_VARIANTS)}, K4 {per_rank(('stagewise_k4',))}, "
            f"K6 {per_rank(('stagewise_k6',))} launches a rank (batch sizes {batches}); rank 0's collectives "
            f"{st['calls']} calls, {st['bytes']} bytes, "
            f"{1e3 * st['seconds']:.1f} ms")
    if waves:
        line += (f"; {waves} waves, {1e3 * wall / waves:.2f} ms a wave, "
                 f"{st['calls'] / waves:.1f} collectives, "
                 f"{st['bytes'] / waves:.0f} bytes and "
                 f"{1e3 * st['seconds'] / waves:.2f} ms of them a wave")
    print(line, flush=True)
    return recs


def md_same(name, recs, keys=("obj", "found")):
    """The path's result bitwise equal on every rank (replicated)."""
    import numpy as np

    first = recs[0]["res"]
    for p in recs[1:]:
        for k in keys:
            check(np.array_equal(np.asarray(p["res"][k]),
                                 np.asarray(first[k])),
                  f"{name}: ranks disagree on {k}")


def phase_multi_device(dev):
    """The multi-device layer on the card: one world of MD_WORLD ranks on
    the one card (gloo, payloads through the host) and sub-meshes of its
    first 2, 4 and 8 ranks; then a one-rank world over NCCL. Single-card
    references first, in this process. Eight ranks time-sliced on one card
    measure the machinery (collectives, lock-step), not scaling."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        solve_tree_miqp_stagewise)
    from pyhybridcontrol_tpu_torch.parallel import backend_for, spawn
    from pyhybridcontrol_tpu_torch.models import di_default_weights
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec, solve_miqp_bnb

    t_phase = time.perf_counter()
    ref = {}

    def timed_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    qp, admm, f, h, seed = md_cfg5(dev)
    ref["cfg5"], s5 = timed_s(lambda: md_bnb(solve_miqp_bnb(
        admm, qp, f, h, BnbSpec(**MD_CFG5_SINGLE), init_incumbent=seed)))
    qp, admm, f, h, _, _ = md_di(dev)
    ref["di"] = md_bnb(solve_miqp_bnb(admm, qp, f, h, BnbSpec(**dict(
        MD_DI_SPEC, capacity=4 * MD_DI_SPEC["capacity"]))))
    x0s = phase_rng("md_feedback_batch").uniform(
        -2.0, 2.0, (MD_FB_B, 2)).astype(np.float32)
    ctrl = md_fb_controller(dev)
    fb, s_fb = timed_s(lambda: ctrl.feedback_batch(x0s))
    ref["tree"] = md_tree_controller(dev).feedback(list(X0_6))
    swt, swtp, data, eu = md_cfg6(dev)
    ref["cfg6"] = md_bnb(solve_tree_miqp_stagewise(
        swt, *data, BnbSpec(**MD_CFG6_SPEC), swt_probe=swtp, ext_u=eu))
    ref["cfg6_par"] = md_bnb(solve_tree_miqp_stagewise(
        swt, *data, BnbSpec(**MD_CFG6_SPEC), swt_probe=swtp, ext_u=eu,
        parallel_sweeps=True))
    host = CondensedMpc(omega_model(), CFG6_N, di_default_weights()).pred
    del ctrl, swt, swtp, data
    torch.cuda.empty_cache()
    print(f"  single card: config 5 {s5:.2f} s, feedback_batch B={MD_FB_B} "
          f"{s_fb:.2f} s", flush=True)

    backend = backend_for(MD_WORLD, "cuda")
    check(backend == "gloo", f"{MD_WORLD} ranks on one card: {backend}")
    t0 = time.perf_counter()
    ranks = spawn(md_rank_body, MD_WORLD, (x0s,), "cuda",
                  timeout=MD_TIMEOUT)
    world_s = time.perf_counter() - t0
    print(f"  world of {MD_WORLD} ranks ({ranks[0]['backend']}, one card): "
          f"{world_s:.1f} s, spawn and set-up included", flush=True)
    check(all(r["backend"] == "gloo" for r in ranks), "the world is not "
          "gloo")
    out = dict(world_s=world_s, backend="gloo", world=MD_WORLD)

    # config 5's pool over 8 ranks
    recs = md_record("md_config5_pool", ranks)
    md_same("md_config5_pool", recs, ("obj", "found", "x", "nodes", "waves"))
    r, s = recs[0]["res"], ref["cfg5"]
    rel = abs(r["obj"] - s["obj"]) / max(1.0, abs(s["obj"]))
    print(f"  config 5, {MD_WORLD} × {MD_CFG5_SPEC['capacity']} slots, wave "
          f"{MD_CFG5_SPEC['wave_size']}: found {r['found']}, objective "
          f"{r['obj']:.5f} on every rank, {r['nodes']} nodes, {r['waves']} "
          f"waves, overflow {r['overflow']}; one card at 4096: "
          f"{s['obj']:.5f} ({s['nodes']} nodes, {s['waves']} waves), "
          f"relative {rel:.2e} (limit 1e-3); the JAX package's CPU reading "
          f"{MD_CFG5_JAX_CPU}", flush=True)
    check(r["found"] and s["found"] and rel <= 1e-3,
          "config 5's sharded pool off the single card")
    check(sum(p["launches"][k] for p in recs for k in K2_VARIANTS) > 0,
          "config 5's pool launched no K2")
    out["config5"] = dict(obj=r["obj"], single_obj=s["obj"],
                          nodes=r["nodes"], waves=r["waves"],
                          wall_s=max(p["wall"] for p in recs),
                          stats=recs[0]["stats"])

    # the double integrator at P=2 and 4
    recs = md_record("md_di_pool", ranks)
    res = {k: [p["res"][k] for p in recs if k in p["res"]]
           for k in ("p2", "p4", "out_of_box", "rel_gap")}
    for k, rs in res.items():
        check(all(x["obj"] == rs[0]["obj"] for x in rs),
              f"md_di_pool {k}: ranks disagree")
        print(f"  double integrator N={MD_DI_N} {k}: found {rs[0]['found']}"
              f", objective {rs[0]['obj']:.5f}, {rs[0]['nodes']} nodes, "
              f"{rs[0]['waves']} waves; one card {ref['di']['obj']:.5f}",
              flush=True)
    for k in ("p2", "p4", "rel_gap"):
        got = res[k][0]
        check(got["found"] and abs(got["obj"] - ref["di"]["obj"])
              <= serve_limit(ref["di"]["obj"]), f"md_di_pool {k} off")
    check(not res["out_of_box"][0]["found"], "out-of-box state found")

    # feedback_batch(mesh=) at config 5's batch
    recs = md_record("md_feedback_batch", ranks)
    md_same("md_feedback_batch", recs, ("obj", "found", "u"))
    got = recs[0]["res"]
    want_obj = fb.obj.cpu().numpy()
    d = np.abs(got["obj"] - want_obj) / np.maximum(1.0, np.abs(want_obj))
    print(f"  feedback_batch B={MD_FB_B} over {MD_FB_P} ranks: found share "
          f"{got['found'].mean():.3f}, worst relative objective against one "
          f"card {d.max():.2e} (limit 1e-3)", flush=True)
    check(np.array_equal(got["found"], fb.found.cpu().numpy())
          and d.max() <= 1e-3, "feedback_batch(mesh=) off the single card")
    out["feedback_batch"] = dict(worst_rel=float(d.max()),
                                 wall_s=max(p["wall"] for p in recs))

    # horizon-sharded condensation
    recs = md_record("md_condense", ranks)
    phi = np.concatenate([p["res"][0] for p in recs])
    gv = np.concatenate([p["res"][1] for p in recs])
    held_rel(f"condense_horizon_sharded config 6 N={CFG6_N} over 4 ranks",
             "condense", {"Phi": max_rel(torch.as_tensor(phi), host["Phi"]),
                          "Gv": max_rel(torch.as_tensor(gv), host["Gv"])})

    # the consensus tree over 2 and 4 ranks
    recs = md_record("md_consensus_tree", ranks)
    want = float(ref["tree"].obj)
    for k in ("p2", "p4"):
        rs = [p["res"][k] for p in recs if k in p["res"]]
        check(all(x["obj"] == rs[0]["obj"] for x in rs),
              f"consensus tree {k}: ranks disagree")
        d = abs(rs[0]["obj"] - want)
        print(f"  consensus tree S=4 N=6 {k}: objective {rs[0]['obj']:.5f} "
              f"({rs[0]['nodes']} nodes), one card {want:.5f}, |Δ| {d:.2e} "
              f"(limit {5e-3 * max(1.0, abs(want)):.2e})", flush=True)
        check(rs[0]["found"] and d <= 5e-3 * max(1.0, abs(want)),
              f"consensus tree {k} off the single card")

    # config 6's stagewise tree over 2 ranks: K4 an iteration
    recs = md_record("md_stagewise_tree", ranks)
    md_same("md_stagewise_tree", recs, ("obj", "found", "x"))
    r, s = recs[0]["res"], ref["cfg6"]
    rel = abs(r["obj"] - s["obj"]) / max(1.0, abs(s["obj"]))
    print(f"  config 6 tree over 2 ranks (K4 sweeps): objective "
          f"{r['obj']:.6f}, {r['nodes']} nodes, {r['waves']} waves; one card "
          f"(K5) {s['obj']:.6f}, relative {rel:.2e} (limit 1e-3)",
          flush=True)
    check(r["found"] and rel <= 1e-3, "config 6 tree over ranks off K5's")
    check(all(p["launches"]["stagewise_k4"] > 0 for p in recs),
          "the stagewise tree over ranks launched no K4")
    out["config6_tree"] = dict(obj=r["obj"], k5_obj=s["obj"],
                               wall_s=max(p["wall"] for p in recs),
                               stats=recs[0]["stats"])

    # the same with parallel_sweeps=True: K6's windowed sweep an iteration
    recs = md_record("md_stagewise_tree_par", ranks)
    md_same("md_stagewise_tree_par", recs, ("obj", "found", "x"))
    r, s = recs[0]["res"], ref["cfg6_par"]
    rel = abs(r["obj"] - s["obj"]) / max(1.0, abs(s["obj"]))
    print(f"  config 6 tree over 2 ranks, parallel_sweeps (K6 over "
          f"windows): objective {r['obj']:.6f}, {r['nodes']} nodes, "
          f"{r['waves']} waves; one card (K5's parallel sweep) "
          f"{s['obj']:.6f}, relative {rel:.2e} (limit 1e-3)", flush=True)
    check(r["found"] and s["found"] and rel <= 1e-3,
          "config 6 tree over ranks with parallel_sweeps off K5's")
    for p in recs:
        check(p["launches"]["stagewise_k6"] > 0 and all(
            v == 0 for k, v in p["launches"].items()
            if k.startswith("stagewise_k") and k != "stagewise_k6"),
            f"md_stagewise_tree_par: K6 and no K4 or K5 on every rank, "
            f"launches {p['launches']}")
    out["config6_tree_par"] = dict(obj=r["obj"], k5_obj=s["obj"],
                                   wall_s=max(p["wall"] for p in recs),
                                   stats=recs[0]["stats"])

    # a one-rank NCCL world
    check(backend_for(1, "cuda") == "nccl", "one rank on its card: not NCCL")
    nccl = spawn(md_nccl_body, 1, (), "cuda", timeout=120)
    recs = md_record("md_nccl", nccl)
    got, plain = recs[0]["res"], nccl[0]["plain"]
    print(f"  one-rank world: backend {nccl[0]['backend']}, sharded "
          f"{got['obj']:.6f} against the unsharded loop {plain['obj']:.6f}",
          flush=True)
    check(nccl[0]["backend"] == "nccl", "the one-rank world is not NCCL")
    check(got["obj"] == plain["obj"] and np.array_equal(got["x"], plain["x"])
          and got["nodes"] == plain["nodes"],
          "one-rank mesh: not the unsharded loop")
    out["wall_s"] = time.perf_counter() - t_phase
    return out


T_START = time.perf_counter()


def ptxas_report(log):
    """The ``-Xptxas -v`` lines on registers and spills, each after the
    kernel instantiation it belongs to (its mangled name, less the
    anonymous namespace)."""
    import re

    fn = "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "",
                        m.group(1))[:48]
        elif "registers" in line or "bytes stack" in line:
            yield f"{fn}: {line.strip()}"


def print_flip_and_cert_readings():
    """--readings: every held probe's instances that round a relaxed
    binary otherwise (with the share allowed) and every held certificate's
    differing bits (with those near a threshold)."""
    for tag, flips, B, off, share in FLIP_READINGS:
        if flips:
            print(f"flips, {tag}: {flips} of {B} ({flips / B:.4f}; allowed "
                  f"{max(1, share * B):g}), farthest {off:.2e} from 0.5",
                  flush=True)
    for tag, n, near, B, far in CERT_READINGS:
        print(f"certificate bits, {tag}: {n} of {B} differ ({n / B:.4f}), "
              f"{near} near a threshold, the farthest within {far:.3g}x",
              flush=True)
    print(f"probes held: {len(FLIP_READINGS)}, with flips: "
          f"{sum(1 for r in FLIP_READINGS if r[1])}; certificates held near "
          f"a threshold: {len(CERT_READINGS)}", flush=True)


def phase(name, fn, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase {name}: {time.perf_counter() - t0:.1f} s]", flush=True)
    return out


def main(argv=None):
    global SEED, READINGS_ONLY
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--readings" in argv:
        argv.remove("--readings")
        READINGS_ONLY = True
    if argv[:1] == ["--seed"] and len(argv) == 2:
        SEED = int(argv[1])
    elif argv:
        print("usage: chip_smoke.py [--seed N] [--readings]",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "pyhybridcontrol_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(pyhybridcontrol_tpu_torch/ not found beside it)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from pyhybridcontrol_tpu_torch.ops import _build

    dev = torch.device("cuda")
    gpu = gpu_line()
    print(gpu, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    for lib in _build.LIBRARIES:
        _build.load_library(lib)
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"({_build.BUILD_INFO.get('paths')})", flush=True)
    for line in ptxas_report(_build.BUILD_INFO.get("log", "")):
        print(f"  ptxas: {line}", flush=True)

    recs = {k: dict(name=k, route="cuda", source=SOURCES[k], replaces=v)
            for k, v in REPLACES.items()}
    phase("K1", phase_k1, dev, phase_rng("k1"), recs["admm_k1"])
    phase("K2", phase_k2, dev, phase_rng("k2"), recs["admm_k2"])
    phase("far", phase_far, dev, phase_rng("far"), recs)
    sweep_args = phase("split-precision", phase_k1_mixed, dev,
                       phase_rng("k1_mixed"), recs["admm_k1_mixed"])
    phase("streamed", phase_streamed, dev, phase_rng("streamed"), recs)
    phase("streamed at the paths' shapes", phase_streamed_paths, dev,
          phase_rng("streamed_paths"), recs)
    phase("streamed at config 4c's waves", phase_tree_shapes, dev,
          phase_rng("tree_shapes"), recs)
    sweep27_args = phase("split mode", phase_split, dev, phase_rng("split"),
                         recs["admm_k1_split"])
    phase("K4", phase_k4, dev, phase_rng("k4"), recs["stagewise_k4"])
    phase("K6 vs plain", phase_k6, dev, phase_rng("k6"),
          recs["stagewise_k6"])
    phase("K5", phase_k5, dev, phase_rng("k5"), recs["stagewise_k5"])
    phase("K5 variants", phase_k5_flex, dev, phase_rng("k5_flex"), recs)
    phase("K5 at any b and r", phase_k5_any, dev, phase_rng("k5_any"), recs)
    phase("K5's parallel sweep", phase_k5_par, dev, phase_rng("k5_par"),
          recs)
    phase("K2 at the surfaces' waves", phase_surface_shapes, dev,
          phase_rng("surface_shapes"), recs)
    phase("K1 at the strong-branching batch", phase_sb_batch, dev,
          phase_rng("sb_batch"), recs)
    phase("K2 at the ranks' shapes", phase_md_shapes, dev,
          phase_rng("md_shapes"), recs)
    calls = dict(mixed_schedule=phase("mixed schedule", phase_mixed_schedule,
                                      dev, phase_rng("mixed_schedule"),
                                      recs))
    for regime, seen in READINGS.items():
        print(f"largest error, {regime} (limit): " + " ".join(
            f"{k}={v:.2e} ({LIMITS[regime][k]:.0e})"
            for k, v in seen.items()), flush=True)
    if READINGS_ONLY:
        print_flip_and_cert_readings()
    if OVER:
        print("off their limits:\n  " + "\n  ".join(OVER), flush=True)
        return 1
    if READINGS_ONLY:
        return 0
    phase("dispatch", phase_dispatch, dev, phase_rng("dispatch"))
    phase("serve config 1", phase_serve, dev)
    phase("serve config 4", phase_serve_batch, dev, sweep_args)
    loops = dict(config1=phase("closed loop config 1", phase_closed_loop,
                               dev),
                 N27=phase("closed loop N=27", phase_closed_loop_n27, dev,
                           sweep27_args, recs["admm_k1_split"]))
    phase("serve config 2", phase_config2_serve, dev)
    calls.update(phase("config 2/2b calls", phase_config2_calls, dev))
    calls["config2_sb"] = phase("config 2 search options",
                                phase_config2_arms, dev, recs)
    calls["config2_cut"] = phase("config 2 cut frame", phase_config2_cut,
                                 dev, recs, calls["config2_sb"])
    calls["condense_device"] = phase("device condensation", phase_condense,
                                     dev, phase_rng("condense"))
    phase("exact hold", phase_exact_hold, dev)
    loops["config3"] = phase("closed loop config 3", phase_config3_loop, dev)
    loops["config4b"] = phase("pooled loop config 4b", phase_config4b_loop,
                              dev)
    calls["config4c_call"] = phase("config 4c call", phase_config4c_call,
                                   dev, recs)
    phase("tree hold", phase_tree_hold, dev)
    calls["config6"] = phase("config 6", phase_config6, dev)
    calls["wide"] = phase("long horizons and wide trees", phase_wide_paths,
                          dev)
    calls["battery_fleet"] = phase("battery fleet", phase_battery_fleet,
                                   dev)
    calls["fleet_b160"] = phase("fleet b=160", phase_fleet_b160, dev,
                                ("fleet_b160",))
    calls["run"] = phase("run CLI", phase_run_cli, dev)
    calls["micro_grid"] = phase("micro-grid", phase_micro_grid, dev)
    calls["decentralized"] = phase("decentralized micro-grid",
                                   phase_decentralized, dev)
    phase("examples", phase_examples, dev)
    calls["multi_device"] = phase("multi-device", phase_multi_device, dev)
    print(json.dumps({"closed_loop": loops, "calls": calls}), flush=True)
    print(f"total: {time.perf_counter() - T_START:.1f} s", flush=True)
    kernels = []
    for k, r in recs.items():
        r["launches_by_path"] = {p: PATH_LAUNCHES[p][k] for p in PATHS}
        r["launches"] = sum(r["launches_by_path"].values())
        r["on_main_path"] = any(PATH_LAUNCHES[p][k] > 0 for p in SERVED)
        if k in FORCED_ONLY:
            check(r["launches"] == 0, f"{k} launched on a driven path: "
                  f"{r['launches_by_path']}")
        else:
            check(r["launches"] > 0, f"{k} was launched on none of the "
                  f"paths")
        kernels.append(r)
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
