#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card and
check what comes out.

Run from the root of a checkout, with one CUDA card and nvcc:

    python3 chip_smoke.py

Before it imports torch it keeps compiled modules under build/pycache
for itself and every process it starts (``use_bytecode_cache``).

Phases, each of which exits non-zero on any failure:

1. device: the card's name and power limit (nvidia-smi), the torch and
   nvcc versions; every kernel of the port is built from ``csrc/``
   (one nvcc per source, all started together), ptxas's registers and
   spills printed (the Hopper bf16 kernels K1, K2 and K3 must not
   spill), and the wgmma (HGMMA) and TMA (UTMALDG) instructions of each
   kernel function counted in its SASS (every instantiation of K1's,
   K2's and K3's bf16 kernels must hold both on its own). Then each
   Hopper building block (TMA loads, wgmma with K-major and MN-major
   operands) is held alone against torch.matmul.
2. kernels: each kernel is held against its plain PyTorch version at
   the shapes GPT-2-small serving and training give it (K1 forward,
   K2/K3 backward at B=8 T=1024, K4 decode), and beside them, in f32
   and bf16: K1-K3 at the tiny presets' head dim 32 (causal, ragged,
   full) and, in bf16, at the XL-class training shape B=8 T=1024 H=16
   D=128; K4 on 64- and 128-token pages and at head dim 32 (K1 also
   on q, k, v as column slices of one fused qkv
   tensor, at T = 12, 17, 731 and 1024, as K2/K3 always are, and at both
   of its block heights; K2/K3 also at T=17, shorter than one tile; K4
   also at one request of 1023 cached tokens and at eight), with the
   tolerance printed beside the error; K2, K3 and K4 run twice on the
   same inputs and must give the same bits. Each is timed (CUDA events
   around a captured CUDA graph of many calls) beside its plain
   version, one PyTorch library call computing the same function (a
   yardstick the port never calls: SDPA; for K2/K3 SDPA's fused
   backward, which computes dq, dk and dv together, timed by
   torch.profiler's device time of its kernels and printed beside
   K2 + K3) and the card's bound for the work (published H100 SXM
   peaks: 989 TFLOP/s bf16, 67 TFLOP/s f32 without tensor cores, 3.35
   TB/s), with the achieved TFLOP/s and the share of the bound (the
   main-shape rows also quote the first designs' times, not measured
   here). K1's 64 and 128 q rows a block are held against each other at
   both main shapes and at BLOCK_ROWS_SHAPES, and the host time of one
   K1, K2 and K3 launch (tensor-map encoding included) is timed.
   TF32 is off for every comparison.
3. engine: LLMEngine serves GPT-2-small in bf16 with seeded random
   weights (block_size 16, max_model_len 1024, max_batch_size 8,
   monolithic prefill, paged decode) for 8 greedy requests of 32
   tokens. The kernels' launch counters are zeroed just before and read
   just after; every request must finish by length with 32 tokens, both
   kernels must have launched, and the pool must drain. Then the
   decode-step logits of one request (through the paged-attention
   kernel) are held against one fresh prefill over prompt + generated
   tokens (through the flash kernel) at the same positions; and the
   same requests run again under torch.profiler, for the device's busy
   share and its time by kernel class.
4. serving paths, each on its own engine, freed before the next:
   engine_default, GPT-2-small at the JAX engine's defaults (chunked
   prefill at 256, the prefix cache, dense decode): the same 8 requests
   (exactly 12 K1 launches per prompt of at most one chunk, no K4), then
   4 requests sharing the first 512 tokens of the 700-token prompt
   (at least 128 pages from the prefix cache, no launch), the pool
   drained, the chunked-prefill + dense-decode logits against a
   monolithic prefill, and a profiled pass; engine_spec, GPT-2-small
   paged with speculative decoding (4 drafts, so K4 at W=5) on 8
   prompts of a repeated 8-token motif, 64 tokens each: accepted <=
   proposed, every committed token the argmax of a fresh prefill's row
   or within LOGITS_TOL["max_abs"] of it (a bf16 near-tie), then the
   same prompts with speculation off; engine_llama, Llama-small paged
   (K1 on K/V repeated to 12 heads, K4 at H_kv=4): both kernels
   launched, decode logits against a prefill. Each of the three also
   serves its requests once more under torch.profiler.
5. tiny: GPT-2 tiny and Llama tiny (head dim 32) through
   ``LLMEngine(EngineConfig(model=m, preset="tiny"))`` at the defaults,
   paged, and paged with 4 drafts, each request finishing by length,
   the pool drained and decode logits held against a prefill; 3 train
   steps of each preset (K1-K3 launches exactly as its remat setting
   says); an engine with 40 drafts and paged attention must raise at
   construction, naming the window. engine_large_pages: GPT-2-small's
   paged engine on 64- and on 128-token pages serving the 8 requests,
   logits against a prefill.
6. train: GPT-2-small training through `make_train_step` (bf16 compute,
   f32 masters, B=8 T=1024, adamw(3e-4, weight_decay=0.1), remat on, 3
   warm-up and 20 timed steps on one fixed batch), with the launch
   counters zeroed around the timed steps: tokens/s, step ms, MFU, peak
   memory, the losses; every loss and grad norm must be finite, the
   last loss below the first, the launches exactly 24 K1, 12 K2 and 12
   K3 a step, and no q, k or v copied to fix its layout. Then 3 steps
   under torch.profiler. train_llama: Llama-small on the same recipe,
   3 warm-up and 10 timed steps, launches exactly 24/12/12 a step, the
   loss falling, then a profile. remat: each RAY_TPU_REMAT_POLICY
   (full, save_flash, save_dots, none) on GPT-2-small and on bench.py's
   XL-class config (E=2048, 16 heads, 12 layers) at B=8 T=1024, 2
   warm-up and 5 timed steps and a profiled step each: tokens/s, step
   ms, MFU, peak memory; K1 must launch 2 L times a step under full and
   L under the others, K2 and K3 L each, and the four first-step losses
   agree. mesh: a one-rank NCCL process group and
   ``build_mesh(MeshSpec(data=1))``; GPT-2-small through
   ``init_sharded_state`` and ``make_train_step(mesh=, rules=,
   zero_stage=)`` at ZeRO stages 0 and 3 (3 warm-up and 10 timed steps)
   and Llama-small at stage 3 (1 and 3), each beside the plain step
   from the same params and batch: launches exactly 24/12/12 a step
   (the kernels on the local shard, through local_map), every loss and
   grad norm within 1e-4 of the plain step's, tokens/s, step ms, device
   busy share, peak memory and the collectives of one step.
7. parity: one f32 train step of GPT-2-small and of Llama-small at full
   width, B=1 T=256, from the same params on the card (kernels) and on
   the CPU (plain versions): the loss, every leaf's grad and updated
   value within the printed tolerances.
8. rl: GRPO through ``ray_tpu_torch.rllib.llm`` (RL_* constants):
   an ``LLMLearner("gpt2", GPT2Config.small())`` at LLMLearnerConfig()'s
   defaults, an ``LLMEngine`` at the JAX engine's defaults built from
   its ``get_weights()``, a RolloutWorker (4 completions of 16 tokens a
   prompt at temperature 1, rewarded by the share of even token ids) and
   an RLFlywheel that hot-swaps with probe streams in flight; 3 laps of
   8 DigitSumTask prompts (a 224-token shared prefix), the launch
   counters zeroed just before and read just after. Each lap must keep
   all 32 trajectories, swap to the learner's version with no probe
   dropped and one at least in flight, give a finite loss and a grad
   norm above 0, launch K1 at least 12 times in the rollout and exactly
   24 K1, 12 K2 and 12 K3 in the update; the engine ends at version 3
   with prefix-cache hits. Lap 1's trajectories' logprobs (engine, bf16)
   against the learner's teacher-forced forward at the same params,
   held to LOGITS_TOL; one more update under torch.profiler. A fresh
   learner's update on a rewarded and an unrewarded completion must
   raise the rewarded token's log-prob margin. One lap on the paged
   engine (K4 at W=1 H=12 H_kv=12) and one of Llama-small, each with
   the same checks; then two updates of ``LLMLearner(mesh=)`` on a
   one-rank NCCL mesh beside the plain learner's, from the same params
   and trajectories: losses and grad norms within 1e-4, 24/12/12
   launches an update.
   Rollout tokens/s, update, swap and ``get_weights`` ms, lap seconds,
   the prefix hit ratio and peak memory are printed beside the card's
   name and power limit. K1, K2 and K3 are also held against their
   plain versions at the learner's B=32 T=256, K1 at the rollout's
   prefill (B=1, T=256 and 226), K4 at the paged lap's decode batch.
9. the rest of the mesh, each phase on a one-rank NCCL process group.
   serve_mesh: ``LLMEngine(mesh=)`` on a ``tensor`` mesh, GPT-2-small at
   EngineConfig()'s defaults and Llama-small paged, on the requests of
   engine_default and engine_llama, whose plain engines in this run are
   the reference: K1 and K4 launches equal to theirs, streams identical
   (or else within the bf16 tie-aware check of engine_spec), the pool
   drained, tokens/s beside the plain engine's, one decode step's
   collectives; GPT-2 then takes an ``update_weights`` of its own
   gathered params and must serve the same streams again. ulysses:
   Ulysses on a ``seq`` mesh, B=8 T=1024 H=12 D=64 bf16, forward and
   backward through ``causal_attention`` (K1, K2, K3, one launch each)
   against a direct ``flash_attention`` call (bit-equal expected,
   BWD_TOL required), and ring attention in f32 against the plain
   reference (RING_TOL), each timed. moe: the MoE layer at GPT-2-small's
   widths (8 experts, top 2, capacity 1.25) on an ``expert`` mesh, x of
   (8, 1024, 768): forward and backward timed, one sequence held against
   the layer in f32 on the CPU (MOE_TOL). pipelined: the pipelined
   transformer at GPT-2-small's widths (12 virtual stages, 4
   microbatches) on a (pipe=1, fsdp=1) mesh, batch 8 x 1024: two SGD
   steps (the loss must fall), the stage_apply chain against the first
   step's loss, step ms and peak memory.
10. classic RL through ``ray_tpu_torch.rllib`` on the card, no K1-K4 on
   these paths (the RL models are products and convolutions outside
   any kernel; PPO_* and the other constants below). Each phase first
   checks that the learner's and the runner's params are on cuda.
   ppo_cartpole: ``PPOConfig().environment("CartPole-v1")...build()``
   with the JAX package's inline recipe (16 envs, fragments of 128, 6
   SGD passes over minibatches of 256) must reach a best
   episode_return_mean of 195 within 40 iterations; env steps/s and
   the sample and learn seconds an iteration (median, max), one
   profiled iteration's device busy share, peak memory; then 3
   iterations with pipeline_sampling. ppo_pixel: the conv recipe on
   PixelCatch-v0 (32 envs, fragments of 40, framestack 2), 45
   iterations: the last return above 2 and the first by 2, the metrics
   tree holding the learner's and the env runners'. ppo_learner_atari:
   ``PPOLearner((84, 84, 4), 6)`` at the catalog's full width
   (ATARI_FILTERS, a 7,744 x 256 projection) on 4,096 seeded
   transitions in minibatches of 256: SGD step ms (CUDA events),
   samples/s, busy share, peak memory, the step's bound, and one f32
   step on the card against the CPU (ATARI_PARITY). dqn_cartpole:
   ``DQNConfig(prioritized_replay=True)`` on CartPole-v1, 20
   iterations: finite TD losses once learning starts, the buffer
   growing, one target sync every target_update_freq updates, epsilon
   decaying; updates/s and peak memory. ppo_learners:
   ``learners(num_learners=1)`` builds; ``num_learners=2`` on a
   one-rank process group is refused, naming both sizes.
11. more RL through ``ray_tpu_torch.rllib`` (the JAX package's recipes,
   F3_ITERS and the other constants below), the launch counters zeroed
   before and read after: no K1-K4 launch. f3_determinism: ppo_pixel's
   recipe four times from the same seeds, with deterministic cuDNN,
   without, without, with: the two runs with it bitwise equal (returns
   and params); the paired difference of each adjacent pair's median
   iteration seconds is the flag's cost. impala_cartpole and
   appo_cartpole: 16 envs x 64 steps with the background learner
   thread, the best return to 195 (APPO above 150, the KL term on)
   within the JAX tests' 240 and 220 s, updates/s, the queue, one
   profiled iteration; the learner's step by CUDA events twice: in the
   run (the interval holds driver work enqueued meanwhile on the same
   stream) and alone, the thread stopped; APPO's target copies =
   updates // 20. sac_pendulum: the port's Pendulum-v1,
   the late returns 300 above the early ones, 0 < alpha < 1.
   dreamer_cartpole_S and dreamer_pixel: DreamerV3 at size S on
   CartPole and at XS on PixelCatch (conv world model, uint8 replay),
   wm/total below 0.8 of its first within 6 iterations, every metric
   finite. multi_agent: a shared policy 21 iterations (last above 20
   and 5 above the first), independent p0/p1 25 iterations (above 20).
   ope: IS, WIS and DR with a policy on the card against the same
   params on the CPU (1e-5) and the on-policy identity (1e-4). Every
   phase checks that its params lie on the card.
12. tune_gpt2: the core API and Tune on the card
   (``ray_tpu_torch.init(local_mode=True, num_gpus=1)``, TUNE_* below).
   A ``num_gpus=1`` task returns a CUDA tensor by reference (the same
   storage), and an actor holding GPT-2-small's params on the card
   answers two calls in order. Then a ``Tuner`` sweeps GPT-2-small's
   learning rate (train's recipe: B=8 T=1024, adamw, full remat, the
   same seeded batch) over four values, two trials training at once
   on two threads under ASHA(max_t=8, grace 2, rf 2), each reporting
   every step and shipping a ``save_train_state`` checkpoint every 4
   steps; one trial then runs 8 steps checkpointed at step 4 only, is
   marked RUNNING in its ``tuner_state.json`` and restored: it resumes
   from step 4 through ``tune.get_checkpoint()`` and
   ``load_train_state``. The launch counters are zeroed just before the
   sweep. Fail unless every loss is finite, the best trial's last loss
   is below its first, ASHA cut a trial before 8 and one finished 8,
   two trials trained at once, K1/K2/K3 launched exactly 24/12/12 times
   the steps taken (sweep, and sweep with the resume), and the restored
   losses at steps 5-8 equal the first run's bit for bit. Prints each
   trial's losses and ASHA's decision, step ms (two at once, one
   alone), checkpoint save and load s and GB/s, peak memory and the
   phase's seconds; the checkpoints are removed at the end.
13. the data layer on the local runtime (``ray_tpu_torch.data``,
   DATA_* and OFFLINE_* below). data_gpt2: seeded token rows written as
   jsonl, read back through the native line scanner (it must build),
   shuffled with a seed, split into inputs and targets by map_batches
   and fed by ``iter_torch_batches`` (pinned host copies onto the card)
   into GPT-2-small's train step (train's recipe, bf16, full remat), 3 +
   10 steps, each fetch inside ``spmd.data_wait()`` with the step
   waterfall on, then again with it off. Fail unless every batch leaf
   is a CUDA int64 tensor of (8, 1024), the batches equal the same
   pipeline's on the CPU bit for bit and in order, K1/K2/K3 launch
   exactly 24/12/12 a step, every loss is finite and the losses of both
   runs equal, bit for bit, those of the same steps fed the CPU batches
   copied to the card directly. Prints ingestion rows/s (the pipeline
   alone), step ms (median, max; with and without the waterfall, fed
   directly) beside the train phase's, data_wait ms a step and the
   phase's seconds. offline_rl: a
   CartPole PPO expert (phase 10's recipe, trained until its best return
   passes 300 as the JAX offline test trains it, and at least to 195),
   40 of its episodes recorded as jsonl, BC and MARWIL 30 iterations
   each (BC's loss falling, each scoring above 150 over 10 greedy
   episodes), importance sampling over the recording read back (finite
   v_target, v_behavior > 0, >= 4 episodes), CQL on 600 recorded
   Pendulum transitions, 10 iterations at cql_alpha 10 and at 0 (a
   finite Bellman loss, ood_gap > 0 at 10 and above the gap at 0, the
   four metrics): the JAX tests' bars; no K1-K4 launch.
14. the cluster runtime (``ray_tpu_torch.init()`` without local mode:
   a head and a nodelet in this process, worker processes under them;
   CLUSTER_* below), after the driver's CUDA cache is emptied. cluster:
   the store is sized through RAY_TPU_OBJECT_STORE_BYTES; prints
   /dev/shm's size, the store's capacity and kind (it must be the native
   one) and GPU == torch.cuda.device_count() in cluster_resources();
   a task's and an actor call's round trip (median and p90 us after a
   warm-up), put/get GB/s of a 256 MiB CPU and CUDA tensor (get timed in
   a GPU actor's process), a worker's spawn-to-ready seconds; a
   num_gpus=0 task must see no card and a num_gpus=1 task the card; two
   num_gpus=0.5 actors must both run on the card while a third stays
   PENDING until one is killed. cluster_gpt2: GPT-2-small's f32 params
   and the train phase's batch (seed 0) are put by the driver; the
   num_gpus=1 actor of a class defined here (pickled by value) that
   read the 256 MiB tensors takes 13 steps of train's recipe and returns its losses, step ms (CUDA events)
   and its process's launch counters: K1/K2/K3 exactly 24/12/12 a step,
   every loss finite and equal, bit for bit, to the same steps run in
   the driver. Then that actor (max_restarts=1), whose worker exits
   mid-method, must come back in a new process that sees the card, a
   task whose worker crashes must be retried to its result, and GPU
   must be back to 1.0 available; shutdown() must leave no worker
   process and no store segment in /dev/shm. Prints the phase's seconds.
15. Train and Tune on the cluster runtime, on a fresh ``init()`` after
   the driver's CUDA cache is emptied (TRAINER_* and TUNE_CLUSTER_RES
   below). trainer_gpt2: ``TorchTrainer`` runs a loop defined here (JAX's
   `_gpt2_loop` at GPT-2-small: the mesh phase's model, batch and adamw
   on a ``data`` mesh over the gang, stage 0, a `save_train_state`
   checkpoint every 4 steps and at the last, a report every step) on a
   one-worker ``use_gpu`` gang joined over NCCL: run A 13 steps
   uninterrupted; run B the same with rank 0's process exiting at step
   9 on its first try, ``FailureConfig(max_failures=1)``, two
   checkpoints kept, so the gang restarts from the step-8 checkpoint.
   Fail unless both finish, each kept only its last two checkpoints,
   run B restarted once into a new pid that saw the card, every step
   of every worker launched K1/K2/K3 exactly 24/12/12 in its own
   process, every loss is finite, run B's losses
   (after the restart too) equal run A's bit for bit, and run A's are
   within MESH_RTOL of the mesh phase's stage-0 losses when that phase
   ran. Prints step ms (median, max; CUDA events in the worker) beside
   the mesh phase's, the seconds from the crash to the new gang's first
   report and where they went (the death seen to the new process, its
   imports and rendezvous, init and the checkpoint's load, the first
   step), checkpoint save and load GB/s and each worker's peak memory.
   tune_cluster: phase 12's ASHA sweep, over its first
   TUNE_CLUSTER_LRS learning rates (the last queued until a process
   frees), and its restore through the Tuner with each trial a worker
   process of its own claiming half the card:
   fail unless two trial processes trained at once, the third trial
   started in a process of its own after one of the first two ended,
   each process launched 24/12/12 a step, every loss is finite and a trial restored
   from its checkpoint in a new process repeats the first run's losses
   bit for bit. Prints step ms with two trial processes at once and one
   alone beside phase 12's two threads and one, and each process's peak
   memory. shutdown() must leave no worker process and no store
   segment. Prints the phase's seconds.
16. pipeline_gpt2: the MPMD pipeline strategy on the cluster runtime,
   on a fresh ``init()`` (PIPELINE_* below): the pipelined transformer
   at PIPELINED_CFG (GPT-2-small's widths, 12 virtual stages, batch 8 x
   1024, M = 4, f32, SGD 1e-2) from the params phase 9 makes (seed 13
   on the card) and phase 9's batch, with two stage processes sharing
   the card (each claiming PIPELINE_STAGE_RES). Run A:
   ``TorchTrainer(strategy="pipeline")``, flat 1F1B, 3 steps and a
   checkpoint at the end; run B: ``PipelineStrategy(num_repeats=2)``
   directly (the interleaved schedule, 4 virtual stages), 2 steps and
   a checkpoint. Fail unless both runs' first two losses are within
   PIPELINED_RTOL of phase 9's in-program losses, the losses fall,
   every stage process has a pid other than the driver's and sees the
   card, every step's bubble is in [0, 1) beside the theoretical
   (S-1)/(S-1+M) and (S-1)/(R*M+S-1), the last step's op spans keep
   the schedule (each stage's ops in its submission order, one at a
   time with their host copies, none started before its input reached
   the host) and give its bubble, run B's checkpoint read back by
   ``load_pipeline_checkpoint`` equals its live params bit for bit and
   run A's (the trainer's) holds the same tree, finite, no stage
   process launched K1-K4, and shutdown() leaves no worker process and
   no store segment. Prints step seconds beside phase 9's, the measured
   and theoretical bubble, the bytes that cross stages in a step and
   the seconds those hops took (the device-to-host copy, the store and
   the host-to-device copy apart), each stage process's peak memory and
   the phase's seconds.
17. runtime_gpu: the runtime on the card (RUNTIME_* below), on one
   ``cluster_utils.Cluster``: its head node is what ``init()`` boots
   (this process, the card's GPU count) with a 512 MiB store, node B has
   the card too. Every process of the phase starts at once, and (c)'s
   loss of B and rebuild on C run beside (a), (b) and (d). (a) a
   num_gpus=1 actor (a class defined here) in a ``runtime_env`` of an
   env var and a working_dir holding a small module: fail unless it
   sees the variable, imports the module from its materialized
   working_dir (its cwd) and sees the card, and its 3 GPT-2-small steps
   (train's recipe, seed 0) launch exactly 24/12/12 a step with losses
   equal, bit for bit, to the driver's same steps. (b) the actor's
   ``num_returns="streaming"`` method takes 12 more steps and yields
   after each a 64 MiB slice of its params (a CUDA tensor) with the
   SHA-256 of its bytes; the driver holds every ref (768 MiB against the
   512 MiB store): fail unless the first item arrives before the last
   step ends, the driver's store spilled at least 256 MiB (the actor's
   worker asks its owner to spill when a create does not fit), every
   item reads back onto the card with the actor's hash, and the stream
   launched 24/12/12 a step. (c) a num_gpus=1 task on node B returns K1's
   forward at B=8 T=1024 H=12 D=64 (bf16); B is removed and node C added
   with the card: fail unless ``get`` rebuilds it by running the task
   again in C's process (one K1 launch) bit-equal to the driver's own K1
   call on the same inputs. (d) PPO at its default of two remote runners
   (8 envs each, fragment 128) with the learner on the card, 5
   iterations: fail unless the runners' pids are not the driver's, their
   weights equal the learner's after the sync (max diff 0) and every
   loss is finite. Nothing may outlive ``shutdown()``. Prints one line a
   part (seconds, process starts and a card process's start split into
   torch's import and its CUDA context, bytes spilled and spill GB/s,
   item latencies, launches, env steps/s beside ppo_cartpole's) and the
   phase's seconds.
18. serve_gpt2: Serve on the cluster runtime (SERVE_* below), on a
   fresh ``cluster_utils.Cluster`` whose head node (this process) has
   the card. ``serve.run(build_llm_app(model="gpt2", preset="small",
   num_replicas=2))`` at phase 3's engine config (paged decode) with an
   explicit SERVE_NUM_BLOCKS-page pool, each replica claiming half the
   card; the deployment class is ServeReplica, a subclass of
   ``LLMServer`` defined here, which reports its process's start, its
   launch counters and its params' checksum. The controller, the
   replicas and the proxy start at once, while the driver builds the
   GRPO learner from seed 0. (a) Phase 3's 8 prompts stream at once
   through ``handle.options(stream=True)`` and one more through the
   proxy's NDJSON path: fail unless every replica's params equal the
   driver's seed-0 GPT-2-small, each stream has one event a token with
   contiguous indices and ends by length, its tokens are phase 3's or,
   from where they differ, each within LOGITS_TOL["max_abs"] of a fresh
   prefill's row max (bf16 near-ties break either way across batch
   compositions), and the replicas' K1 and K4 counters (zeroed after
   their warmup) are above 0. (b) a second wave of the same 8 streams;
   ``chaos.kill_replica(busiest=True)`` fires once every stream has
   delivered two events: fail unless all 8 finish with no error, pass
   the same check against the first wave, at least one stream failed
   over, ``serve.status()`` shows a restart and 2 healthy replicas, and
   the replacement answers a request (the seconds from the kill to its
   first token are printed). (c) a ``RolloutWorker(handle=)`` samples a
   DigitSumTask group; the learner updates once on the driver (exactly
   24/12/12 launches), ``publish_weights()`` returns a ref and
   ``handle.update_weights`` sends it: fail unless every replica reports
   weight version 1 and the next group's trajectories are tagged 1
   with logprobs within LOGITS_TOL of the learner's teacher-forced
   forward at its new params (the first group's at its old ones).
   Nothing may outlive ``shutdown()``. Prints each replica's start
   (split into torch's import, its CUDA context, the engine's build,
   which imports the serving modules, and its warmup), wave 1's TTFT and tokens/s beside phase
   3's, the heal time, the swap's put and get seconds, the launches and
   the phase's seconds.
19. dag_gpt2: collectives, channels and compiled graphs on the cluster
   runtime (DAG_* below), on a fresh ``cluster_utils.Cluster`` whose
   head node (this process) has the card. Two actors of DagStage (a
   class defined here) claim half the card each and take seed-0
   GPT-2-small from one put (their params' checksums must equal the
   driver's); rank 1 may restart once. The group's coordinator, each
   actor's first forward and backward, and the driver's references run
   while the actors start. (a) Stage 0 (the embedding, blocks [0,
   DAG_SPLIT)) and stage 1 (the other blocks, the final norm, the last
   position's logits) are bound with ``bind`` and compiled with rings of
   DAG_CHANNEL_MSGS f32 activations; after one warm execution,
   DAG_EXECS executions are submitted before any ``get``: fail unless
   each output equals the eager ``.remote()`` chain's bit for bit and
   gpt2_forward's last position within LOGITS_TOL, the head takes no
   get_actor, create_actor, kv_put or kv_get and the nodelet no
   schedule_task(s), request_lease or start_actor meanwhile,
   ``dag_executions_total`` moves by DAG_EXECS + 1 compiled and 0
   eager_fallback, and each stage process launches K1 exactly 6 an
   execution. (b) Both join a ``util.collective`` group; each takes the
   LM grads of its own batch (train's shape and recipe; exactly 24/12/12
   launches) and ``allreduce(op=MEAN)``s them: fail unless both results
   are CUDA tensors equal, bit for bit, to the driver's ``(g0 + g1) *
   0.5``; then rank 0's params are broadcast, the losses gathered, a
   barrier passed, and a DAG_SEND_BYTES CUDA tensor sent through
   send/recv and through a ShmCommunicator, each equal to what was sent.
   (c) The graph compiled again, DAG_KILL_EXECS executions submitted and
   rank 1's process killed: fail unless all come back equal to (a)'s
   through the eager fallback (at least one), the restarted process
   launches K1, no channel slot outlives ``teardown()`` and nothing
   ``shutdown()``. Prints the actors' start, compiled and eager
   executions a second and their latency, a stage's compute, the
   allreduce's seconds and GB/s, ``collective_seconds`` by op, both
   transports' GB/s, the seconds from the kill to the restart and to
   the last result, and the phase's seconds by part.
20. observe_gpt2: the observability planes (OBSERVE_* below). Parts (a)
   and (b) run right after the train phase (6), on the driver. (a)
   Phase 3's 8 requests through an engine at the JAX engine's defaults
   but for the paged decode, submitted under one ``tracing.span``: fail unless each
   request's ``llm.request`` span sits under the root's trace with its
   prefill and decode children, each breakdown sums to its e2e within
   5 % (the JAX test's bar), the SLO histograms (TTFT and TPOT) hold
   the 8 requests, K1 launched 12 times for each prompt of at most one
   prefill chunk and K4 12 times a decode step. (b) Phase 5's state
   takes OBSERVE_TRAIN_STEPS more steps with the step waterfall on, inside
   ``tracing.profiler_capture(OBSERVE_DIR, device="cuda")``: fail
   unless they launch exactly 24/12/12 a step, the waterfall's phases
   and each step's ``train.step.*`` spans sum to its host time within
   5 %, and the chrome trace written into OBSERVE_DIR holds one device
   event a launch of K1, K2 and K3 (OBSERVE_KERNELS, counted by
   ``tracing.kernel_events``). (c) On phase 19's cluster, after its part (c) and with its rank-0 actor
   (no new card process): a driver span around a call to the actor that
   prints, logs and submits a task: fail unless all three share the
   span's trace id, also on the merged timeline; the actor trains
   GPT-2-small for OBSERVE_LOOP_S (24/12/12 launches a step) while
   ``state.profile`` samples the cluster for OBSERVE_PROFILE_S: fail
   unless the stacks of the actor's process name its loop, its
   ``train_step_seconds`` shows tagged by its node on
   ``state.cluster_metrics()`` and on the head's ``start_metrics_http``
   page, ``cluster_logs(trace_id=)`` returns its print and its log
   record, a threshold rule given to the head's Watchtower when phase
   19 built it (the median train step landing in its window), quiet
   until the loop, fires in ``alerts()``, and ``debug_dump`` writes
   every artifact with no
   error. Prints one line with the parts' seconds and each check.

21. tools_gpt2: the cluster tools (TOOLS_* below), last, after every RL
   phase. (a) On the driver, GPT-2-small's train step takes
   OBSERVE_TRAIN_STEPS steps inside ``tracing.profiler_capture``: fail
   unless the chrome trace holds one device event a launch of K1, K2
   and K3 (the capture itself raises when the trace holds fewer events
   of a kernel than its block launched). (b) ``launcher.up`` boots a
   cluster from a config dict (a head of CPUs only, a "gpu" type of one
   CPU and one GPU, 0 to 1 of them) as ``python -m
   ray_tpu_torch.scripts.cli start`` processes, with a v2 Reconciler
   over ``launcher.LaunchedNodeProvider``. ``cli submit --no-wait``
   submits chip_job.py, whose driver (under the job's supervisor, no
   card) reserves a placement group of one CPU and one GPU, which stays
   pending until the Reconciler launches the gpu node, and starts in it
   a detached GPT-2-small actor that takes TOOLS_STEPS train steps on
   the card: fail unless the job ends SUCCEEDED, its logs hold its JSON
   line with finite losses and launches of exactly 24/12/12 a step, its
   driver loaded no torch and saw no card, `cli job list` and `cli job
   status` and the dashboard's jobs view name it, and a second job
   (``sleep 60``) stopped ends STOPPED. (c) A workflow run from this
   driver: a CPU step draws a token batch, a step trains TOOLS_WF_STEPS
   steps in the named actor, a step with ``max_retries=0`` ends its own
   worker until a marker exists: fail unless `run` raises, the status
   is RESUMABLE, `resume` (after the marker) returns the second step's
   losses and the batch's checksum without moving the actor's launch
   counters, and the status is SUCCESS. (d) With the actor killed and
   its group removed, the Reconciler takes the idle gpu node down: fail
   unless the node went QUEUED, REQUESTED, ALLOCATED, RAY_RUNNING,
   TERMINATING, TERMINATED with one launch and one termination, and
   after ``launcher.down`` no node process is left. The only card
   process it starts is the actor's. Prints one line with the parts'
   seconds; fails if the phase took more than TOOLS_BUDGET_S.
Last, every process this run started and that is still there (a
descendant of this process, or one whose environment names this process
as its nodelet's) is listed in a ``{"stray_processes": [...]}`` line,
with its command, state and start, and stopped; the script fails if one
does not go. It prints one JSON line per kernel shape and per phase,
K4's rows on the serving and rl paths with their launches there (by
window and heads), then
a ``{"kernels": [...]}`` line whose launches are split by path, and as
its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# bf16 times of the first designs of the kernels (mma.sync, synchronous
# loads), measured by an earlier version of this script on an NVIDIA
# H100 80GB HBM3 at 700 W: quoted as "earlier_ms" beside each main-shape
# row, never measured by this run and left out of the "kernels" line
EARLIER_SOURCE = ("the first design's time, quoted from EARLIER_MS, not "
                  "measured in this run")
EARLIER_MS = {("flash_fwd", 8): 0.2736, ("flash_fwd", 1): 0.0693,
              ("flash_dq", 8): 0.3225, ("flash_dkv", 8): 0.4264,
              ("paged_attention", 8): 0.0196}
# the Hopper building blocks alone against torch.matmul on the same bf16
# values: f32 sums of at most 128 products differ in order only
HOPPER_TOL = 1e-3
# K1 bf16 shapes, beside the main ones, at which 64 and 128 q rows a
# block are held against each other (the launch's choice between them,
# `default_block_rows` in csrc/flash_attention.cu, rests on these):
# (B, T, causal) at H=12 D=64, no mask, long and many short sequences
BLOCK_ROWS_SHAPES = ((8, 1024, False), (2, 4096, True), (2, 4096, False),
                     (32, 256, True))
# tolerances of each kernel against its plain version: f32 differs in
# summation order only; bf16 also rounds the softmax weights and the
# output to bf16 (half an ulp at 1.0 is 0.004)
TOL = {
    "flash_fwd": {"float32": {"o": 1e-4, "lse": 1e-4},
                  "bfloat16": {"o": 2e-2, "lse": 1e-3}},
    "paged_attention": {"float32": {"o": 1e-4}, "bfloat16": {"o": 2e-2}},
}
# the backward kernels against their plain version, elementwise
# |kernel - plain| <= atol + rtol |plain|: f32 differs in summation order
# only; in bf16 both round p and ds to bf16 before the products, so they
# differ where a value lands on the other side of a rounding step, and
# in the output's last bit (an ulp is 2^-7 relative)
BWD_TOL = {"float32": {"atol": 1e-4, "rtol": 1e-4},
           "bfloat16": {"atol": 2e-2, "rtol": 2e-2}}
# decode logits (paged kernel, one token per step) against one prefill
# (flash kernel) over the same tokens: both run GPT-2-small in bf16,
# whose residual stream rounds at other places on the two paths (on an
# H100 the seeded run differs by at most 0.032, 0.0046 on average)
LOGITS_TOL = {"max_abs": 0.1, "mean_abs": 0.01}
ENGINE_PROMPTS = (700, 600, 530, 300, 90, 40, 17, 12)
MAX_TOKENS = 32
# engine_default's second wave: the first SHARED_PREFIX tokens of wave
# 1's longest prompt, each with its own random SUFFIX
SHARED_PREFIX, SUFFIX, WAVE2 = 512, 64, 4
# engine_spec: K drafts, prompts of a SPEC_MOTIF-token motif repeated to
# SPEC_PROMPT tokens
SPEC_K, SPEC_REQUESTS, SPEC_MOTIF, SPEC_PROMPT, SPEC_TOKENS = 4, 8, 8, 64, 64
# the training recipe of bench.py's GPT-2-small flagship, on one card
TRAIN_BATCH = (8, 1024)
TRAIN_WARMUP, TRAIN_STEPS, PROFILE_STEPS = 3, 20, 3
# card (kernels, cuBLAS) against CPU (plain versions) for one f32 step:
# both compute in f32 and differ in summation order; the grad tolerance
# is relative to the leaf's largest grad; one Adam step moves a param by
# at most lr (1 + weight decay |p|), so the updated-param tolerance is
# what a near-zero grad flipping sign could cost
PARITY_BATCH = (1, 256)
PARITY_TOL = {"loss": 1e-4, "grad_rel": 1e-3, "param": 1e-3}
# Llama-small on bench.py's recipe: 3 warm-up and LLAMA_STEPS timed steps
LLAMA_STEPS = 10
# the remat phase: each RAY_TPU_REMAT_POLICY on GPT-2-small and on
# bench.py's XL-class config (E=2048, 16 heads, 12 layers, one card), 2
# warm-up and 5 timed steps each. Every policy starts from the same
# params and batch and changes only what the backward keeps, not what it
# computes: each step's loss and grad norm (the later losses read the
# updates, so a wrong backward shows there) must equal "full"'s within
# REMAT_TRAJ_RTOL, relative. The runs are deterministic: on an H100 all
# four policies gave the same bits at both sizes
REMAT_POLICIES = ("full", "save_flash", "save_dots", "none")
# bench.py's GPT-2 "XL-class" config for one card (~709 M parameters)
XL_CLASS = {"n_layer": 12, "n_head": 16, "n_embd": 2048}
REMAT_WARMUP, REMAT_STEPS = 2, 5
REMAT_TRAJ_RTOL = 1e-4
# the mesh phase: GPT-2-small through make_train_step(mesh=, rules=) on
# a one-rank NCCL mesh at ZeRO stages MESH_STAGES (MESH_WARMUP warm-up
# and MESH_STEPS timed steps each) and Llama-small at stage 3 (one
# warm-up and MESH_LLAMA_STEPS timed steps), bench.py's recipe; every
# step's loss and grad norm against the plain step's from the same
# params and batch, relative (at world 1 both run the same local
# operators, so the bound is tight). NCCL refuses two ranks on one GPU,
# and gloo's all_gather_into_tensor on CUDA tensors kills the rank with
# SIGSEGV (torch 2.11), so no run of two ranks shares the card
MESH_STAGES = (0, 3)
MESH_WARMUP, MESH_STEPS, MESH_LLAMA_STEPS = 3, 10, 3
MESH_RTOL = 1e-4
# the tiny presets: prompts of these lengths (of the presets' 128
# positions), TINY_TOKENS new tokens each; TINY_TRAIN_STEPS train steps
# on a (B, T) batch
TINY_PROMPTS = (90, 47, 20, 9, 3)
TINY_TOKENS = 16
TINY_TRAIN_BATCH = (4, 128)
TINY_TRAIN_STEPS = 3
# the rl phases: GRPO through ray_tpu_torch.rllib.llm at the JAX engine's
# defaults and LLMLearnerConfig()'s, RL_PROMPTS DigitSumTask prompts a lap
# (a RL_PREFIX-token shared system prefix, 14 pages of 16, then two
# digits), RL_GROUP completions of RL_TOKENS tokens each at temperature
# 1: 32 trajectories a lap, a learner batch of 32 x 256 tokens (the
# train phase's 8,192 a step); RL_LAPS laps of GPT-2-small, then one
# paged lap and one Llama-small lap
RL_PROMPTS, RL_GROUP, RL_TOKENS, RL_PREFIX, RL_LAPS = 8, 4, 16, 224, 3
# updates of the world-1 mesh learner and of the plain one, the second
# of each timed warm
RL_MESH_UPDATES = 2
# the rest of the mesh, each on a one-rank NCCL process group. ulysses:
# causal attention over a `seq` mesh through Ulysses with the flash
# kernels as attn_fn, bf16, fwd + bwd against one direct flash_attention
# call (at one rank the all-to-all is the identity, so the bits should
# agree); ring attention at the same shape in f32 against the plain
# einsum reference (one ring step at one rank: f32 sums in another
# order, within RING_TOL elementwise); each timed over MESH_TIME_ITERS
# calls after one warm call
ULYSSES_SHAPE = (8, 1024, 12, 64)
RING_TOL = {"atol": 1e-4, "rtol": 1e-4}
MESH_TIME_ITERS = 5
# moe: the layer at GPT-2-small's widths on an `expert` mesh, bf16
# expert products; MOE_CHECK_BATCH sequences of the batch held against
# the same function in f32 on the CPU. Tokens whose top-2 experts differ
# (an f32 near-tie of two gate probabilities computed on two devices)
# may number at most MOE_MAX_REROUTED; over the others the outputs agree
# to bf16's rounding of the tokens, the hidden activations and the output
# (an ulp is 2^-7 relative; the CPU's own bf16 layer differs from its f32
# one by at most 0.033 at this size, outputs up to 5): |card - cpu| <=
# atol + rtol |cpu| elementwise
MOE_CFG = dict(d_model=768, d_ff=3072, num_experts=8, top_k=2,
               capacity_factor=1.25)
MOE_X = (8, 1024, 768)
MOE_CHECK_BATCH = 1
MOE_MAX_REROUTED = 4
MOE_TOL = {"atol": 5e-2, "rtol": 2e-2}
# pipelined: the pipelined transformer at GPT-2-small's widths (12
# virtual stages of one block, 12 heads, 4 microbatches) on a (pipe=1,
# fsdp=1) mesh, batch 8 of 1024 tokens, two SGD steps (lr 1e-2); the
# chain of stage_apply over PIPELINED_CHAIN_STAGES stages against the
# first step's pipelined_loss, relative (f32, the same math in another
# batching)
PIPELINED_CFG = dict(vocab_size=50304, n_virtual_stages=12, n_head=12,
                     d_model=768, d_ff=3072, block_size=1024,
                     num_microbatches=4)
PIPELINED_BATCH = 8
PIPELINED_CHAIN_STAGES = 2
PIPELINED_RTOL = 1e-4
# classic RL (phase 10): the JAX package's inline recipes. ppo_cartpole
# must reach a best episode_return_mean of PPO_TARGET within PPO_ITERS
# iterations, then runs PPO_PIPELINED_ITERS with pipeline_sampling;
# ppo_pixel is the conv recipe (framestack 2) without its 4-device mesh
PPO_CARTPOLE = dict(num_env_runners=0, num_envs_per_env_runner=16,
                    rollout_fragment_length=128)
PPO_CARTPOLE_TRAINING = dict(num_sgd_iter=6, minibatch_size=256)
PPO_ITERS = 40
PPO_TARGET = 195.0
PPO_PIPELINED_ITERS = 3
PPO_PIXEL = dict(num_env_runners=0, num_envs_per_env_runner=32,
                 rollout_fragment_length=40)
PPO_PIXEL_TRAINING = dict(lr=2.5e-3, framestack=2, entropy_coeff=0.02,
                          num_sgd_iter=6, minibatch_size=256, gamma=0.95)
PPO_PIXEL_ITERS = 45
# ppo_learner_atari: the catalog's full width (ATARI_FILTERS and a
# 256-wide projection) on a seeded batch of ATARI_BATCH transitions, one
# SGD pass over minibatches of ATARI_MINIBATCH; one f32 SGD step on the
# card against the same step on the CPU (TF32 off): the loss relative,
# each updated leaf within ATARI_PARITY["param"] of its largest element
ATARI_OBS = (84, 84, 4)
ATARI_ACTIONS = 6
ATARI_BATCH = 4096
ATARI_MINIBATCH = 256
ATARI_PARITY = {"loss_rel": 1e-4, "param": 1e-3}
# dqn_cartpole: the JAX inline recipe with prioritized replay, DQN_ITERS
# iterations and no learning threshold
DQN_RUNNERS = dict(num_env_runners=0, num_envs_per_env_runner=8,
                   rollout_fragment_length=32)
DQN_TRAINING = dict(updates_per_iteration=64,
                    num_steps_sampled_before_learning=500)
DQN_ITERS = 20
# more RL (phase 11): the JAX package's recipes for the families that run
# without a runtime. f3_determinism runs ppo_pixel's recipe F3_ITERS
# iterations, twice with deterministic cuDNN and twice without.
# IMPALA and APPO must reach their bars within the JAX tests' own time
# limits. SAC stops once the mean of the last 20 returns from iteration
# SAC_LATE on beats the mean of the first 20 by SAC_GAIN. DreamerV3 at
# size S keeps the config's B=8 T=16 H=15 and replays 16 batches an
# iteration (training_ratio 32: the JAX test's 16 updates of its smaller
# batches); on pixels it is the JAX test's XS recipe
F3_ITERS = 10
UPDATE_ALONE = 20  # learner steps timed with the learner thread stopped
IMPALA_CARTPOLE = dict(num_env_runners=0, num_envs_per_env_runner=16,
                       rollout_fragment_length=64)
IMPALA_TARGET = 195.0
IMPALA_LIMIT_S = 240.0
APPO_TRAINING = dict(lr=1e-3, entropy_coeff=0.01, use_kl_loss=True)
APPO_TARGET = 150.0
APPO_LIMIT_S = 220.0
SAC_TRAINING = dict(seed=1, num_envs=4, rollout_fragment_length=16,
                    updates_per_iteration=48,
                    num_steps_sampled_before_learning=1000)
SAC_ITERS = 160
SAC_LATE = 60
SAC_GAIN = 300.0
DREAMER_S = dict(model_size="S", training_ratio=32.0, seed=0)
DREAMER_PIXEL = dict(model_size="XS", training_ratio=8.0, batch_size_B=4,
                     batch_length_T=8, horizon_H=5, num_envs=4,
                     rollout_fragment_length=16, seed=0)
DREAMER_ITERS = 6
DREAMER_METRICS = ("wm/decoder", "wm/reward", "wm/dyn", "wm/rep",
                   "actor/entropy", "critic/value", "imagined_return")
MA_SHARED_ITERS = 21
MA_INDEPENDENT_ITERS = 25
OPE_TOL = 1e-5
CARD = "cuda"  # where phase 11 puts the tensors it makes itself
# tune_gpt2 (phase 12): an ASHA sweep of GPT-2-small's learning rate on
# the local runtime, two trials training at once, each on TRAIN_BATCH
# from seed 0 with adamw and full remat; a train state checkpoint every
# TUNE_CKPT_EVERY steps under TUNE_DIR (1.49 GB each in f32, removed at
# the end); then a one-trial run of TUNE_MAX_T steps checkpointed at
# TUNE_CKPT_EVERY only, interrupted and restored. The grid starts from
# the largest lr: ASHA passes the first loss to reach a rung and cuts a
# later one that falls outside the rung's top 1/TUNE_RF, so trials that
# arrive in order from worst to best (the smallest lr first, when a
# larger lr learns faster, as it did on the CPU at 2 layers) would all
# pass
TUNE_LRS = (3e-3, 1e-3, 3e-4, 1e-4)
TUNE_MAX_T = 8
TUNE_GRACE = 2
TUNE_RF = 2
TUNE_CONCURRENT = 2
TUNE_CKPT_EVERY = 4
TUNE_RESUME_LR = 1e-3
TUNE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "tune_gpt2")
# data_gpt2 (phase 13): DATA_ROWS seeded token rows of TRAIN_BATCH[1] + 1
# tokens (twice the DATA_WARMUP + DATA_STEPS batches of TRAIN_BATCH[0]
# rows the run takes) written as jsonl under DATA_DIR, read back,
# shuffled with DATA_SEED, split into inputs and targets and fed to
# GPT-2-small's train step; offline_rl: a CartPole PPO expert trained to
# OFFLINE_EXPERT_RETURN (the JAX offline test's loop) within
# OFFLINE_EXPERT_ITERS iterations, OFFLINE_EPISODES recorded episodes,
# BC and MARWIL OFFLINE_ITERS iterations each (the eval bar
# OFFLINE_EVAL_BAR over OFFLINE_EVAL_EPISODES), IS over the recording,
# and CQL on CQL_STEPS Pendulum transitions with test_cql.py's config
DATA_WARMUP, DATA_STEPS = 3, 10
DATA_ROWS = TRAIN_BATCH[0] * (DATA_WARMUP + DATA_STEPS) * 2
DATA_SEED = 7
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "data_gpt2")
OFFLINE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "offline_rl")
OFFLINE_EXPERT_RETURN = 300.0
OFFLINE_EXPERT_ITERS = 80
OFFLINE_EPISODES = 40
OFFLINE_ITERS = 30
OFFLINE_EVAL_EPISODES = 10
OFFLINE_EVAL_BAR = 150.0
CQL_STEPS = 600
CQL_ITERS = 10
CQL_TRAINING = dict(hidden=(64, 64), train_batch_size=128, lr=1e-3,
                    updates_per_iteration=32, seed=0)
# cluster (phase 14): the store holds GPT-2-small's f32 params (124.5M x
# 4 B = 498 MB) and the 256 MiB put/get tensors with room to spare;
# CLUSTER_RTT_CALLS round trips timed one by one after CLUSTER_RTT_WARMUP;
# CLUSTER_GPT2_STEPS train steps in the GPU actor and again in the driver
CLUSTER_STORE_BYTES = 1536 << 20
CLUSTER_RTT_WARMUP, CLUSTER_RTT_CALLS = 50, 300
CLUSTER_PUT_BYTES = 256 << 20
CLUSTER_GPT2_STEPS = 13
CLUSTER_WAIT_S = 60.0  # every get and wait of the phase
# trainer_gpt2 (phase 15): TorchTrainer on a one-worker use_gpu gang,
# TRAINER_STEPS steps of the mesh phase's GPT-2-small stage-0 run (its
# warm-up and timed steps, so the losses line up), a save_train_state
# checkpoint every TRAINER_CKPT_EVERY steps and at the last (1.49 GB
# each, two kept, under TRAINER_DIR, removed at the end); run B's rank 0
# exits its process at step TRAINER_CRASH_AT on its first try and the
# gang restarts from the step-8 checkpoint. tune_cluster: phase 12's
# sweep over its first TUNE_CLUSTER_LRS learning rates (TUNE_CONCURRENT
# trial processes at once and one more queued behind them; phase 12
# sweeps all four in-process) and its restore, each trial in a worker
# process of its own, claiming TUNE_CLUSTER_RES (two trials share the
# card)
TRAINER_STEPS = MESH_WARMUP + MESH_STEPS
TRAINER_CKPT_EVERY = 4
TRAINER_CRASH_AT = 9
TRAINER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "trainer_gpt2")
TUNE_CLUSTER_RES = {"CPU": 1.0, "GPU": 0.5}
TUNE_CLUSTER_LRS = TUNE_LRS[:TUNE_CONCURRENT + 1]
# pipeline_gpt2 (phase 16): two stage processes share the card, each
# claiming PIPELINE_STAGE_RES; run A (TorchTrainer, flat 1F1B) takes
# PIPELINE_A_STEPS steps and checkpoints at the last under PIPELINE_DIR
# (removed at the end), run B (PipelineStrategy, PIPELINE_B_REPEATS
# virtual stages a process) PIPELINE_B_STEPS
PIPELINE_STAGE_RES = {"CPU": 1.0, "GPU": 0.5}
PIPELINE_STAGES = 2
PIPELINE_A_STEPS = 3
PIPELINE_B_STEPS = 2
PIPELINE_B_REPEATS = 2
PIPELINE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "pipeline_gpt2")
# runtime_gpu (phase 17): a 512 MiB store; (a) RUNTIME_STEPS train steps
# in a GPU actor whose runtime_env sets RUNTIME_ENV_VAR and ships a
# working_dir holding RUNTIME_MODULE; (b) RUNTIME_ITEMS more steps, each
# yielding a RUNTIME_ITEM_BYTES CUDA tensor through a stream, at least
# RUNTIME_SPILL_MIN of them spilled; (c) K1 at RUNTIME_K1_SHAPE (bf16)
# rebuilt on another node; (d) PPO at RUNTIME_PPO for RUNTIME_PPO_ITERS
RUNTIME_STORE_BYTES = 512 << 20
RUNTIME_STEPS = 3
RUNTIME_ENV_VAR = ("RUNTIME_GPU_FLAG", "phase17")
RUNTIME_MODULE = "runtime_gpu_mod"
RUNTIME_MODULE_VALUE = "from-working-dir"
RUNTIME_ITEMS = 12
RUNTIME_ITEM_BYTES = 64 << 20
RUNTIME_SPILL_MIN = 256 << 20
RUNTIME_K1_SHAPE = (8, 1024, 12, 64)
RUNTIME_K1_SEED = 17
RUNTIME_PPO = dict(num_env_runners=2, num_envs_per_env_runner=8,
                   rollout_fragment_length=128)
RUNTIME_PPO_TRAINING = dict(num_sgd_iter=6, minibatch_size=256)
RUNTIME_PPO_ITERS = 5
# serve_gpt2 (phase 18): SERVE_REPLICAS replicas of the app SERVE_APP,
# each claiming SERVE_GPU_SHARE of the card, phase 3's engine config with
# a pool of SERVE_NUM_BLOCKS 16-token pages (8 lanes x 64 pages + slack,
# ~340 MB of bf16 KV a replica: up to three engines share the card while
# a killed replica's replacement starts); a SERVE_STORE_BYTES store holds
# the published weights; every wait of the phase is SERVE_WAIT_S
SERVE_APP = "gpt2"
SERVE_REPLICAS = 2
SERVE_GPU_SHARE = 0.5
SERVE_NUM_BLOCKS = 8 * 64 + 64
SERVE_STORE_BYTES = 1536 << 20
SERVE_WAIT_S = 120.0
# dag_gpt2 (phase 19): two actors of GPT-2-small (seed 0), each claiming
# DAG_GPU_SHARE of the card, on a cluster with a DAG_STORE_BYTES store
# (the params, the driver's averaged grads and the four trees of one
# allreduce round in flight, 497 MB each in f32). (a) a compiled
# two-stage forward, stage 0 the embedding and blocks [0, DAG_SPLIT),
# stage 1 the rest, the final norm and the last position's logits, one
# warm and DAG_EXECS timed executions over DAG_BATCH token batches from
# seed DAG_SEED, each channel ring DAG_CHANNEL_MSGS f32 activations
# long (a message may fill half a ring), DAG_LATENCY_RUNS serial
# executions a path for its latency; (b) a data-parallel step at train's
# batch shape, rank r's batch from seed DAG_DP_SEED + r, through the
# collective group DAG_GROUP, then a DAG_SEND_BYTES CUDA tensor (seed
# DAG_SEND_SEED) through send/recv and a ShmCommunicator; (c)
# DAG_KILL_EXECS executions through a kill of rank 1. Every wait is
# DAG_WAIT_S; the phase's bar is DAG_BUDGET_S (printed beside its
# seconds, not checked)
DAG_GPU_SHARE = 0.5
DAG_STORE_BYTES = 4 << 30
DAG_BATCH = (4, 256)
DAG_SPLIT = 6
DAG_EXECS = 32
DAG_SEED = 19
DAG_CHANNEL_MSGS = 4
DAG_LATENCY_RUNS = 5
DAG_DP_SEED = 190
DAG_GROUP = "dag_gpt2"
DAG_SEND_BYTES = 64 << 20
DAG_SEND_SEED = 191
DAG_KILL_EXECS = 16
DAG_WAIT_S = 120.0
DAG_BUDGET_S = 75.0
# observe_gpt2 (phase 20): (a) phase 3's engine and requests (but the
# JAX engine's defaults beside the paged decode) under one span, (b)
# OBSERVE_TRAIN_STEPS of train's GPT-2-small steps with the step
# waterfall on inside a torch.profiler capture into OBSERVE_DIR, (c) on
# phase 19's cluster, rank 0 trains GPT-2-small (train's recipe, batch
# seed OBSERVE_SEED) for OBSERVE_LOOP_S while an OBSERVE_PROFILE_S
# cluster profile runs, and the threshold rule OBSERVE_RULE (over a
# window of OBSERVE_RULE_WINDOW_S), given to phase 19's head (its
# Watchtower sampling every OBSERVE_WATCH_PERIOD_S), must fire; waits are DAG_WAIT_S, spans, log records and the alert are
# polled for OBSERVE_POLL_S; the phase's bar is OBSERVE_BUDGET_S
# (printed beside its seconds, not checked)
OBSERVE_TRAIN_STEPS = 3
OBSERVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "observe_gpt2")
OBSERVE_SEED = 20
OBSERVE_LOOP_S = 3.0
OBSERVE_PROFILE_S = 2.0
OBSERVE_POLL_S = 15.0
OBSERVE_RULE = "observe-gpt2-trained"
OBSERVE_RULE_WINDOW_S = 15.0
OBSERVE_WATCH_PERIOD_S = 1.0
OBSERVE_BUDGET_S = 40.0
# the launch counters of K1-K3, whose kernels a profiled train step's
# chrome trace must hold one event a launch of
OBSERVE_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device milliseconds per call over `iters` back-to-back calls,
    replayed from one captured CUDA graph: launched one by one from
    Python, a call of a few tens of microseconds is bound by the host
    and the events would time the gaps between launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_ms(torch, fn, iters: int) -> float | None:
    """Mean device milliseconds per call of the kernels `fn` launches,
    summed from torch.profiler's device time over `iters` calls (CUDA
    activity only): for a call that cannot be captured in a CUDA graph
    (autograd runs a backward on the stream of its forward), where
    events around the Python launches would time the host's gaps.
    None when the profiler sees no device time."""
    ms = sum(profiled_by_kernel(torch, fn, iters).values())
    return ms if ms > 0 else None


def profiled_by_kernel(torch, fn, iters: int) -> dict[str, float]:
    """Mean device milliseconds per call of `fn`, by kernel name, from
    torch.profiler over `iters` calls (CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.key_averages():
        us = device_us(ev)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key[:80]] = out.get(ev.key[:80], 0.0) + us / 1e3 / iters
    return out


def device_us(ev) -> float:
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0.0))


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def dname(torch, dtype) -> str:
    return str(dtype).replace("torch.", "")


def rate(row: dict, flops: float) -> None:
    """Add the achieved TFLOP/s and the share of the bound to a timed
    row."""
    row["tflops"] = flops / row["kernel_ms"] / 1e9
    row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]


def host_us(torch, fn, iters: int = 200) -> float:
    """Host microseconds to enqueue one call (the device left to run
    behind): the wrapper's checks, its tensor-map encoding and the
    ctypes launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / iters
    torch.cuda.synchronize()
    return us


# ------------------------------------------------------------ phase 1


def phase_device(torch) -> str:
    """The card's name and power limit (returned as nvidia-smi prints
    them), the toolchain's versions, and every kernel built."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    for line in card.splitlines():
        print(line.strip(), flush=True)
    from ray_tpu_torch import _build

    ver = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60, check=False)
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"nvcc: {ver.stdout.strip().splitlines()[-1]}", flush=True)
    t0 = time.perf_counter()
    try:
        built = _build.build_all(_build.KERNELS + ("hopper_check",))
    except RuntimeError as e:
        fail(str(e))
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "warning")):
                print(f"  {name}: {line.strip()}", flush=True)
        for fn, spilled in spills(info["log"]).items():
            if spilled and any(k in fn for k in HOPPER_KERNELS):
                fail(f"{name}: {fn} spills {spilled} bytes")
    # one cuobjdump a library, all at once
    with concurrent.futures.ThreadPoolExecutor(len(built)) as pool:
        futures = {name: pool.submit(sass_counts, _build, info["path"])
                   for name, info in built.items()}
    try:
        sass = {name: f.result() for name, f in futures.items()}
    except RuntimeError as e:
        fail(str(e))
    # each TMA/wgmma kernel on its own: every instantiation must hold
    # both, so that one kernel of a library cannot stand in for another
    for kernel in TMA_KERNELS:
        found = {fn: c for by_fn in sass.values() for fn, c in by_fn.items()
                 if kernel in fn}
        if not found:
            fail(f"{kernel}: not found in any library's SASS")
        for fn, counts in found.items():
            if not all(counts.values()):
                fail(f"{fn}: no wgmma or TMA instruction in its SASS: "
                     f"{counts}")
    emit({"phase": "build", "seconds": build_s,
          "libraries": {n: os.path.basename(i["path"])
                        for n, i in built.items()},
          "sass_counts": sass})
    return card


# the kernels written for Hopper (wgmma, TMA): ptxas must not spill them,
# and each of TMA_KERNELS must hold both in its own SASS
TMA_KERNELS = ("flash_fwd_bf16_kernel", "flash_dq_bf16_kernel",
               "flash_dkv_bf16_kernel")
HOPPER_KERNELS = TMA_KERNELS + ("hopper_check_kernel",)


def spills(log: str) -> dict[str, int]:
    """Bytes of spill stores plus loads per function in ptxas -v output."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        elif fn and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out[fn] = nums[1] + nums[2]  # stack frame, stores, loads
            fn = None
    return out


def sass_counts(_build, path: str) -> dict[str, dict[str, int]]:
    """wgmma (HGMMA) and TMA load (UTMALDG) instructions of each kernel
    function in a library's SASS (cuobjdump from nvcc's toolkit, split
    at its ``Function :`` headers), by mangled name."""
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300, check=False)
    if res.returncode != 0:
        # raised, not failed: this runs on a pool's thread, and the
        # caller's result() raises it on the main thread
        raise RuntimeError(f"cuobjdump -sass {path}: {res.stderr.strip()}")
    out: dict[str, dict[str, int]] = {}
    counts = None
    for ln in res.stdout.splitlines():
        if "Function :" in ln:
            counts = out.setdefault(ln.split("Function :")[-1].strip(),
                                    {"HGMMA": 0, "UTMALDG": 0})
        elif counts is not None:
            for op in counts:
                counts[op] += op in ln
    return out


def check_hopper(torch, gen) -> None:
    """Each Hopper building block alone (csrc/hopper_check.cu): TMA
    loads with the 128-byte swizzle, wgmma from K-major shared-memory
    operands (form 0: a b^T) and from a register A with an MN-major B
    (form 1: a b), against torch.matmul on the same bf16 values."""
    import ctypes

    from ray_tpu_torch import _build

    lib = _build.load("hopper_check")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.bind(lib.rt_hopper_check, [P, P, P, I, I, I, P])
    describe = _build.bind(lib.rt_hopper_check_error_string, [I],
                           ctypes.c_char_p)
    stream = torch.cuda.current_stream().cuda_stream
    errs = {}
    for form, n, k in ((0, 64, 64), (0, 64, 128), (0, 128, 64),
                       (0, 128, 128), (1, 64, 64), (1, 128, 64)):
        a = torch.randn((64, k), generator=gen, device="cuda").bfloat16()
        b = torch.randn((n, k) if form == 0 else (k, n), generator=gen,
                        device="cuda").bfloat16()
        c = torch.full((64, n), float("nan"), device="cuda")
        _build.check(fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), form, n,
                        k, stream), "hopper_check", describe)
        torch.cuda.synchronize()
        ref = a.float() @ (b.float().T if form == 0 else b.float())
        err = (c - ref).abs().max().item()
        errs[f"form{form}_n{n}_k{k}"] = err
    emit({"phase": "hopper_check", "max_abs_err": errs, "tol": HOPPER_TOL})
    bad = {k: e for k, e in errs.items() if not e <= HOPPER_TOL}
    if bad:
        fail(f"hopper building blocks against torch.matmul: max abs err "
             f"{bad} (tol {HOPPER_TOL})")


# ------------------------------------------------------------ phase 2


# K1, K2 and K3 at the shapes of the tiny presets (H=4, D=32; the
# tiny train step's B and T, a ragged length, no mask) and, in bf16, at
# the XL-class training shape of the remat phase (H=16, D=128);
# (B, T, H, D, causal)
FLASH_TINY_SHAPES = ((4, 128, 4, 32, True), (2, 77, 4, 32, True),
                     (1, 128, 4, 32, False))
# K1 alone at the tiny engines' prefill: one prompt padded to its bucket,
# a power of two from 16 to max_model_len 128
FLASH_TINY_PREFILL = tuple((1, T, 4, 32, True) for T in (16, 32, 64, 128))
FLASH_XL_SHAPE = (8, 1024, 16, 128, True)
# K1, K2 and K3 at the rl phases' shapes, H=12 D=64: the learner's batch
# of 32 trajectories padded to T=256 (K1 also in Llama's forward, on K/V
# repeated to 12 heads); K1 alone at the rollout's monolithic prefill, a
# 226-token prompt padded to its bucket of 256, and at the prompt's own
# ragged length; (B, T, D, causal), named by RL_FLASH_ROWS
RL_FLASH_SHAPES = ((32, 256, 64, True), (1, 256, 64, True),
                   (1, 226, 64, True))
RL_FLASH_ROWS = ("rl_learner", "rl_prefill", "rl_prefill_ragged")
# K1 as a dag_gpt2 pipeline stage runs it: (B, T, D, causal) at H=12
DAG_FLASH_SHAPE = (4, 256, 64, True)


def flash_cases(torch, shapes) -> list:
    """(dtype, B, T, H, D, causal): `shapes` at H=12 and the tiny shapes
    in f32 and bf16, then the XL-class shape in bf16."""
    cases = [(dtype, B, T, 12, D, causal)
             for dtype in (torch.float32, torch.bfloat16)
             for B, T, D, causal in shapes]
    cases += [(dtype, *shape) for dtype in (torch.float32, torch.bfloat16)
              for shape in FLASH_TINY_SHAPES]
    return cases + [(torch.bfloat16, *FLASH_XL_SHAPE)]


def check_flash(torch, gen) -> dict:
    """K1 against its plain version; returns the bf16 T=1024 rows of the
    serving prefill (B=1) and of training (B=8) as "serve" and "train",
    the XL-class training row as "train_xl", and the tiny train step's
    in bf16 (GPT-2 tiny) and f32 (Llama tiny) as "tiny" and
    "tiny_f32"."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    main = {}
    # the prefill buckets, the training shape; then a ragged length, no
    # mask, D = 128
    for dtype, B, T, H, D, causal in flash_cases(torch, (
            (1, 64, 64, True), (1, 512, 64, True), (1, 1024, 64, True),
            (8, 1024, 64, True), (1, 731, 64, True), (1, 256, 64, False),
            (1, 256, 128, True), DAG_FLASH_SHAPE) + RL_FLASH_SHAPES) + [
                (dtype, *shape) for dtype in (torch.float32, torch.bfloat16)
                for shape in FLASH_TINY_PREFILL]:
        dn = dname(torch, dtype)
        scale = 1.0 / math.sqrt(D)
        q, k, v = (torch.randn((B, T, H, D), generator=gen,
                               device="cuda").to(dtype)
                   for _ in range(3))
        o_ref, lse_ref = fa._fwd_plain(q, k, v, causal, scale)
        tol = TOL["flash_fwd"][dn]
        # the launch's own choice, then (bf16) both block heights
        for rows in (0, 64, 128) if dtype == torch.bfloat16 else (0,):
            o, lse = fa._fwd(q, k, v, causal, scale, block_rows=rows)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            if not (math.isfinite(err_o) and err_o <= tol["o"]
                    and err_lse <= tol["lse"]):
                fail(f"flash_fwd {dn} T={T} D={D} causal={causal} "
                     f"block_rows={rows or 'default'}: o err {err_o} "
                     f"(tol {tol['o']}), lse err {err_lse} (tol "
                     f"{tol['lse']})")
            if rows == 0:
                row_err = (err_o, err_lse)
        err_o, err_lse = row_err
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        ms = cuda_ms(torch, lambda: fa._fwd(q, k, v, causal, scale), 50)
        plain_ms = cuda_ms(
            torch, lambda: fa._fwd_plain(q, k, v, causal, scale),
            20 if B == 1 else 5)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal), 50)
        esz = q.element_size()
        pairs = T * (T + 1) / 2 if causal else T * T
        flops = 4.0 * B * H * D * pairs
        nbytes = 4.0 * B * T * H * D * esz + 4.0 * B * H * T
        b_ms, b_by = bound(flops, nbytes, dn)
        row = {"kernel": "flash_fwd", "dtype": dn,
               "shape": {"B": B, "T": T, "H": H, "D": D,
                         "causal": causal},
               "max_abs_err_o": err_o, "tol_o": tol["o"],
               "max_abs_err_lse": err_lse, "tol_lse": tol["lse"],
               "kernel_ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b_ms,
               "bound_by": b_by}
        rate(row, flops)
        if T == 1024:
            row["host_us"] = host_us(
                torch, lambda: fa._fwd(q, k, v, causal, scale))
        if dtype == torch.bfloat16 and (B, T, H, D) == FLASH_XL_SHAPE[:4]:
            main["train_xl"] = row
        if (B, T, H, D, causal) == FLASH_TINY_SHAPES[0]:
            main["tiny" if dtype == torch.bfloat16 else "tiny_f32"] = row
        if dtype == torch.bfloat16 and (B, T, D, causal) in RL_FLASH_SHAPES:
            main[RL_FLASH_ROWS[RL_FLASH_SHAPES.index((B, T, D, causal))]] \
                = row
        if dtype == torch.bfloat16 and H == 12 and \
                (B, T, D, causal) == DAG_FLASH_SHAPE:
            main["dag_stage"] = row
        if dtype == torch.bfloat16 and T == 1024 and D == 64:
            row["earlier_ms"] = EARLIER_MS[("flash_fwd", B)]
            row["earlier_ms_source"] = EARLIER_SOURCE
            # 64 against 128 q rows a block (two warpgroups share
            # each k/v tile, but half as many blocks fill the SMs)
            row["ms_by_block_rows"] = {
                r: cuda_ms(torch, lambda r=r: fa._fwd(
                    q, k, v, causal, scale, block_rows=r), 50)
                for r in (64, 128)}
            main["serve" if B == 1 else "train"] = row
        emit(row)
    check_flash_views(torch, gen, main)
    check_flash_block_rows(torch, gen)
    return main


def check_flash_block_rows(torch, gen) -> None:
    """K1 in bf16 at BLOCK_ROWS_SHAPES with 64 and with 128 q rows a
    block: each held against the plain version and timed, beside SDPA
    and the launch's own choice."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    H, D, scale = 12, 64, 0.125
    tol = TOL["flash_fwd"]["bfloat16"]
    for B, T, causal in BLOCK_ROWS_SHAPES:
        q, k, v = (torch.randn((B, T, H, D), generator=gen,
                               device="cuda").bfloat16() for _ in range(3))
        o_ref, lse_ref = fa._fwd_plain(q, k, v, causal, scale)
        errs = {}
        for rows in (64, 128):
            o, lse = fa._fwd(q, k, v, causal, scale, block_rows=rows)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            if not (math.isfinite(err_o) and err_o <= tol["o"]
                    and err_lse <= tol["lse"]):
                fail(f"flash_fwd bf16 B={B} T={T} causal={causal} "
                     f"block_rows={rows}: o err {err_o} (tol {tol['o']}), "
                     f"lse err {err_lse} (tol {tol['lse']})")
            errs[rows] = err_o
        del o_ref, lse_ref
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = T * (T + 1) / 2 if causal else T * T
        flops = 4.0 * B * H * D * pairs
        nbytes = 4.0 * B * T * H * D * 2 + 4.0 * B * H * T
        b_ms, b_by = bound(flops, nbytes, "bfloat16")
        ms = {r: cuda_ms(torch, lambda r=r: fa._fwd(
            q, k, v, causal, scale, block_rows=r), 50) for r in (64, 128)}
        row = {"kernel": "flash_fwd", "dtype": "bfloat16",
               "shape": {"B": B, "T": T, "H": H, "D": D, "causal": causal},
               "max_abs_err_o_by_block_rows": errs, "tol_o": tol["o"],
               "kernel_ms": cuda_ms(torch, lambda: fa._fwd(
                   q, k, v, causal, scale), 50),
               "ms_by_block_rows": ms,
               "tflops_by_block_rows": {r: flops / t / 1e9
                                        for r, t in ms.items()},
               "library_ms": cuda_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       qh, kh, vh, is_causal=causal), 50),
               "bound_ms": b_ms, "bound_by": b_by}
        row["library_tflops"] = flops / row["library_ms"] / 1e9
        emit(row)


def check_flash_views(torch, gen, main: dict) -> None:
    """K1 in bf16 on q, k, v as the model hands them over, column slices
    of one (B, T, 3 H D) projection: at the training shape (timed) and
    at the short and ragged prompt lengths. TMA reads the slices as they
    are: no layout copy may be made."""
    from ray_tpu_torch.ops import flash_attention as fa

    H, D, scale = 12, 64, 0.125
    tol = TOL["flash_fwd"]["bfloat16"]
    for B, T in ((8, 1024), (1, 12), (1, 17), (1, 731)):
        qkv = torch.randn((B, T, 3 * H * D), generator=gen,
                          device="cuda").bfloat16()
        q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
        copies = fa.LAYOUT_COPIES.count
        o, lse = fa._fwd(q, k, v, True, scale)
        o_ref, lse_ref = fa._fwd_plain(q, k, v, True, scale)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        if not (math.isfinite(err_o) and err_o <= tol["o"]
                and err_lse <= tol["lse"]):
            fail(f"flash_fwd bf16 qkv views B={B} T={T}: o err {err_o} "
                 f"(tol {tol['o']}), lse err {err_lse} (tol {tol['lse']})")
        if fa.LAYOUT_COPIES.count != copies:
            fail(f"flash_fwd bf16 qkv views B={B} T={T}: the wrapper "
                 f"copied the model's views")
        row = {"kernel": "flash_fwd", "dtype": "bfloat16",
               "layout": "qkv column slices",
               "shape": {"B": B, "T": T, "H": H, "D": D, "causal": True},
               "max_abs_err_o": err_o, "tol_o": tol["o"],
               "max_abs_err_lse": err_lse, "tol_lse": tol["lse"]}
        if B == 8:
            row["kernel_ms"] = cuda_ms(
                torch, lambda: fa._fwd(q, k, v, True, scale), 50)
            row["contiguous_ms"] = main["train"]["kernel_ms"]
        emit(row)


# K4's decode batch: context lengths from an empty lane to a full table
PAGED_CTX = (0, 1, 17, 130, 511, 640, 1000, 1023)


def paged_inputs(torch, gen, dtype, ctx_list, H, HK, W, bs, D, C=1024):
    """Seeded operands of paged_attention for len(ctx_list) sequences of
    up to C cached tokens (a random permutation of the pool's pages,
    page 0 left as the null page)."""
    S = len(ctx_list)
    maxB = C // bs
    npages = S * maxB + 1
    k_pages, v_pages = (torch.randn((npages, bs, HK, D), generator=gen,
                                    device="cuda").to(dtype)
                        for _ in range(2))
    perm = torch.randperm(npages - 1, generator=gen, device="cuda") + 1
    tables = perm[:S * maxB].reshape(S, maxB).int().contiguous()
    ctx_len = torch.tensor(ctx_list, dtype=torch.int32, device="cuda")
    q = torch.randn((S, W, H, D), generator=gen, device="cuda").to(dtype)
    ok, ov = (torch.randn((S, W, HK, D), generator=gen,
                          device="cuda").to(dtype) for _ in range(2))
    return q, ok, ov, k_pages, v_pages, tables, ctx_len


# The engine's speculative verify runs K4 one lane at a time (S=1, W=5)
# over the lane's context; engine_spec's contexts run from 64 to 127
# tokens, VERIFY_CTX is their middle
VERIFY_CTX = (96,)

# The tiny engines' layout: max_model_len 128 on 16-token pages, a table
# of 8 pages. Their decode batch is 5 prompts of TINY_PROMPTS padded to
# 8 lanes (the padding at context 0), contexts below 128; their verify
# runs one lane at contexts from 3 to 123 (pos + 4 drafts < 128), whose
# middle is TINY_VERIFY_CTX
TINY_C = 128
TINY_DECODE_CTX = (0, 3, 9, 20, 47, 90, 105, 127)
# the rl_paged lap's decode batch: 8 lanes of a 226-token prompt and up to
# 15 generated tokens, in GPT-2-small's engine layout (tables of 64 pages)
RL_DECODE_CTX = (226, 228, 230, 232, 234, 236, 238, 241)
TINY_VERIFY_CTX = (47,)

# K4's bf16 rows that the serving paths run: GPT-2's decode batch (the
# kernel's main row), GPT-2's verify window of four drafts on one lane,
# and Llama-small's grouped-query decode batch (three query heads a KV
# head); (ctx_len per sequence, (H, H_kv, W, block_size, D, C), dtype),
# C the cached tokens a table holds
PAGED_PATH_ROWS = {
    "decode": (PAGED_CTX, (12, 12, 1, 16, 64, 1024), "bfloat16"),
    "verify": (VERIFY_CTX, (12, 12, 5, 16, 64, 1024), "bfloat16"),
    "gqa_decode": (PAGED_CTX, (12, 4, 1, 16, 64, 1024), "bfloat16"),
    # GPT-2-small's decode batch on 64- and 128-token pages (phase_tiny's
    # large-page engines)
    "decode_bs64": (PAGED_CTX, (12, 12, 1, 64, 64, 1024), "bfloat16"),
    "decode_bs128": (PAGED_CTX, (12, 12, 1, 128, 64, 1024), "bfloat16"),
    # the tiny presets' decode and verify (D=32) in their engines'
    # layout: GPT-2 tiny's four heads in bf16, Llama tiny's two query
    # heads a KV head in f32
    "tiny_decode": (TINY_DECODE_CTX, (4, 4, 1, 16, 32, TINY_C), "bfloat16"),
    "tiny_gqa_decode": (TINY_DECODE_CTX, (4, 2, 1, 16, 32, TINY_C),
                        "float32"),
    "tiny_verify": (TINY_VERIFY_CTX, (4, 4, 5, 16, 32, TINY_C), "bfloat16"),
    "tiny_gqa_verify": (TINY_VERIFY_CTX, (4, 2, 5, 16, 32, TINY_C),
                        "float32"),
    "rl_decode": (RL_DECODE_CTX, (12, 12, 1, 16, 64, 1024), "bfloat16")}


def k4_launches(by_shape: dict, W: int, H: int, HK: int,
                S: int | None = None) -> int:
    """K4's launches in `by_shape` (labels of launch_shape) at window W
    over H query and HK KV heads, at S sequences or at any S."""
    want = {"W": W, "H": H, "H_kv": HK}
    if S is not None:
        want["S"] = S
    n = 0
    for label, count in by_shape.items():
        have = {k: int(v) for k, v in
                (kv.split("=") for kv in label.split())}
        if all(have.get(k) == v for k, v in want.items()):
            n += count
    return n


def check_paged(torch, gen) -> dict:
    """K4 against its plain version; returns the rows of PAGED_PATH_ROWS
    by name."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops import paged_attention as pa

    main = {}
    dtypes = (torch.float32, torch.bfloat16)
    # (dtype, ctx_len per sequence, H, H_kv, W, block_size, D, C)
    cases = [(dtype, PAGED_CTX, H, HK, W, bs, D, 1024)
             for dtype in dtypes
             # decode, a verify window, GQA decode and window; then the
             # other page sizes, D = 128
             for H, HK, W, bs, D in ((12, 12, 1, 16, 64), (12, 12, 5, 16, 64),
                                     (12, 4, 1, 16, 64), (12, 4, 5, 16, 64),
                                     (12, 12, 1, 8, 64), (12, 4, 5, 32, 64),
                                     (8, 8, 1, 16, 128))]
    # 64- and 128-token pages, each walked as tiles of 32 rows, at D 64
    # and 128; head dim 32 over a full table
    cases += [(dtype, PAGED_CTX, 12, HK, W, bs, 64, 1024)
              for dtype in dtypes
              for bs in (64, 128) for HK in (12, 4) for W in (1, 5)]
    cases += [(dtype, PAGED_CTX, 8, HK, W, bs, 128, 1024)
              for dtype in dtypes
              for bs in (64, 128) for HK, W in ((8, 1), (2, 5))]
    cases += [(dtype, PAGED_CTX, 4, HK, W, bs, 32, 1024)
              for dtype in dtypes
              for HK, W, bs in ((4, 1, 16), (4, 5, 16), (2, 1, 16),
                                (2, 5, 16), (4, 1, 64), (2, 5, 128))]
    # the tiny engines' own layout (TINY_C), for GPT-2 tiny's heads and
    # Llama tiny's grouped-query heads: their decode batch of 8 lanes,
    # one lane's decode (the logits check replays one request), and the
    # verify window on one lane over its range of contexts
    cases += [(dtype, ctx, 4, HK, W, 16, 32, TINY_C)
              for dtype in dtypes for HK in (4, 2)
              for W, ctx in ((1, TINY_DECODE_CTX), (1, (3,)), (1, (105,)),
                             (5, (3,)), (5, TINY_VERIFY_CTX), (5, (96,)),
                             (5, (123,)))]
    # one long request, a decode batch of full contexts, and the rl_paged
    # lap's decode batch
    cases += [(torch.bfloat16, ctx, 12, 12, 1, 16, 64, 1024)
              for ctx in ((1023,), (1023,) * 8, RL_DECODE_CTX)]
    # the verify window on one lane, as the engine launches it: S=1
    # splits each (sequence, KV head) far finer than S=8 does, under the
    # causal own window, for GPT-2's heads and for grouped-query heads
    cases += [(torch.bfloat16, ctx, 12, HK, 5, 16, 64, 1024)
              for HK, ctxs in ((12, ((17,), VERIFY_CTX, (130,), (1023,))),
                               (4, ((17,), (130,), (1023,))))
              for ctx in ctxs]
    for dtype, ctx_list, H, HK, W, bs, D, C in cases:
        dn = dname(torch, dtype)
        S = len(ctx_list)
        args = paged_inputs(torch, gen, dtype, ctx_list, H, HK, W, bs, D, C)
        q, ok, ov, k_pages, v_pages, tables, ctx_len = args
        out = pa.paged_attention(*args)
        ref = pa.paged_attention_reference(*args)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL["paged_attention"][dn]["o"]
        shape = {"S": S, "W": W, "H": H, "H_kv": HK, "D": D,
                 "block_size": bs, "max_blocks": C // bs,
                 "ctx_len": list(ctx_list)}
        if not (math.isfinite(err) and err <= tol):
            fail(f"paged_attention {dn} {shape}: err {err} (tol {tol})")
        # no atomics: the splits merge in a fixed order, so a second run
        # gives the same bits
        if not torch.equal(pa.paged_attention(*args), out):
            fail(f"paged_attention {dn} {shape}: two runs differ")
        # yardstick: one SDPA call over the context gathered ahead of
        # time, with the length and own-window masks as one mask
        rep = H // HK
        k_all = torch.cat([k_pages[tables.long()].reshape(S, C, HK, D),
                           ok], 1).repeat_interleave(rep, 2)
        v_all = torch.cat([v_pages[tables.long()].reshape(S, C, HK, D),
                           ov], 1).repeat_interleave(rep, 2)
        kh, vh = (t.transpose(1, 2).contiguous() for t in (k_all, v_all))
        qh = q.transpose(1, 2).contiguous()
        ctx_ok = torch.arange(C, device="cuda")[None, :] \
            < ctx_len.long()[:, None]
        own_ok = torch.ones(W, W, dtype=torch.bool, device="cuda").tril()
        mask = torch.cat([ctx_ok[:, None, :].expand(S, W, C),
                          own_ok[None].expand(S, W, W)], -1)[:, None]
        lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        lib_err = (lib.transpose(1, 2).float() - ref.float()).abs().max()
        ms = cuda_ms(torch, lambda: pa.paged_attention(*args), 100)
        plain_ms = cuda_ms(
            torch, lambda: pa.paged_attention_reference(*args), 20)
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask), 100)
        esz = q.element_size()
        n_ctx = sum(ctx_list)
        pages_read = sum((c + bs - 1) // bs for c in ctx_list)
        flops = 4.0 * H * D * W * (n_ctx + S * (W + 1) / 2)
        nbytes = esz * (2 * S * W * H * D + 2 * S * W * HK * D
                        + 2 * n_ctx * HK * D) + 4 * (pages_read + S)
        b_ms, b_by = bound(flops, nbytes, dn)
        n_split, pages = pa.split_plan(S, HK, C // bs, bs)
        row = {"kernel": "paged_attention", "dtype": dn, "shape": shape,
               "split_plan": {"n_split": n_split, "pages_per_split": pages},
               "max_abs_err": err, "tol": tol, "bitwise_repeat": True,
               "library_err": lib_err.item(),
               "kernel_ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
        rate(row, flops)
        if dtype == torch.bfloat16 and (H, HK, W, bs, D) == (
                12, 12, 1, 16, 64):
            # the kernel's device time by the profiler, beside the
            # graph-timed mean
            row["device_ms_by_kernel"] = profiled_by_kernel(
                torch, lambda: pa.paged_attention(*args), 20)
        for name, path_row in PAGED_PATH_ROWS.items():
            if (ctx_list, (H, HK, W, bs, D, C), dn) == path_row:
                main[name] = row
        if (ctx_list, (H, HK, W, bs, D, C), dn) == PAGED_PATH_ROWS["decode"]:
            row["earlier_ms"] = EARLIER_MS[("paged_attention", S)]
            row["earlier_ms_source"] = EARLIER_SOURCE
        emit(row)
    return main


def sdpa_bwd(torch, q, k, v, do, causal: bool):
    """The library yardstick for K2 and K3: one autograd call through
    PyTorch's fused attention backward (the one SDPA's autograd uses),
    computing dq, dk and dv together on (B, H, T, D) copies. Returns a
    function that runs it, or None with the reason printed."""
    import torch.nn.functional as F

    qh, kh, vh = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)

    def call():
        return torch.autograd.grad(out, (qh, kh, vh), doh,
                                   retain_graph=True)

    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"  sdpa backward yardstick unavailable: {e}", flush=True)
        return None
    return call


def check_flash_bwd(torch, gen) -> dict:
    """K2 and K3 against their plain version at the training shape and
    beside it; returns the bf16 training-shape rows by kernel name."""
    from ray_tpu_torch.ops import flash_attention as fa

    main = {}
    # the training shape; then a ragged length, one shorter than a tile
    # (TMA's zero fill stands in for masked loads), no mask, D = 128
    for dtype, B, T, H, D, causal in flash_cases(torch, (
            (8, 1024, 64, True), (1, 731, 64, True), (2, 17, 64, True),
            (1, 256, 64, False), (1, 256, 128, True),
            RL_FLASH_SHAPES[0])):
        dn = dname(torch, dtype)
        tol = BWD_TOL[dn]
        scale = 1.0 / math.sqrt(D)
        # q, k, v as column slices of one fused projection, as the
        # model hands them over
        qkv = torch.randn((B, T, 3 * H * D), generator=gen,
                          device="cuda").to(dtype)
        q, k, v = (t.reshape(B, T, H, D)
                   for t in qkv.split(H * D, dim=-1))
        do = torch.randn((B, T, H, D), generator=gen,
                         device="cuda").to(dtype)
        o, lse = fa._fwd(q, k, v, causal, scale)
        delta = fa._delta(o, do)
        got = fa._bwd(q, k, v, o, lse, do, causal, scale)
        ref = fa._bwd_plain(q, k, v, o, lse, do, causal, scale)
        torch.cuda.synchronize()
        errs = {}
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            diff = (g.float() - r.float()).abs()
            errs[name] = diff.max().item()
            excess = (diff - tol["atol"]
                      - tol["rtol"] * r.float().abs()).max().item()
            if not (math.isfinite(errs[name]) and excess <= 0):
                fail(f"flash bwd {name} {dn} B={B} T={T} D={D} "
                     f"causal={causal}: max abs err {errs[name]} "
                     f"(tol {tol})")
        # no atomics: a second run on the same inputs gives the same
        # bits
        again = fa._bwd(q, k, v, o, lse, do, causal, scale)
        for name, g, g2 in zip(("dq", "dk", "dv"), got, again):
            if not torch.equal(g, g2):
                fail(f"flash bwd {name} {dn} B={B} T={T} D={D} "
                     f"causal={causal}: two runs differ")
        lib = sdpa_bwd(torch, q, k, v, do, causal)
        lib_ms = profiled_ms(torch, lib, 10) if lib else None
        pair_ms = {}
        esz = q.element_size()
        pairs = B * H * (T * (T + 1) / 2 if causal else T * T)
        n = B * T * H * D
        rows_f32 = 2 * 4 * B * H * T  # lse and delta
        for name, products, n_out, launch, plain, err in (
                ("flash_dq", 3, 1,
                 lambda: fa._launch_dq(q, k, v, do, lse, delta,
                                       causal, scale),
                 lambda: fa._bwd_plain(q, k, v, o, lse, do, causal,
                                       scale, want_dkv=False),
                 errs["dq"]),
                ("flash_dkv", 4, 2,
                 lambda: fa._launch_dkv(q, k, v, do, lse, delta,
                                        causal, scale),
                 lambda: fa._bwd_plain(q, k, v, o, lse, do, causal,
                                       scale, want_dq=False),
                 max(errs["dk"], errs["dv"]))):
            ms = cuda_ms(torch, launch, 20)
            plain_ms = cuda_ms(torch, plain, 3 if B > 1 else 10)
            flops = 2.0 * D * pairs * products
            nbytes = esz * n * (4 + n_out) + rows_f32
            b_ms, b_by = bound(flops, nbytes, dn)
            row = {"kernel": name, "dtype": dn,
                   "shape": {"B": B, "T": T, "H": H, "D": D,
                             "causal": causal},
                   "max_abs_err": err, "errors": errs, "tol": tol,
                   "kernel_ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": b_ms,
                   "bound_by": b_by}
            rate(row, flops)
            if B == 8 and D == 64:
                row["host_us"] = host_us(torch, launch)
            if dtype == torch.bfloat16 and (B, T, H, D) == (8, 1024, 12,
                                                            64):
                row["earlier_ms"] = EARLIER_MS[(name, B)]
                row["earlier_ms_source"] = EARLIER_SOURCE
                main[name] = row
            if dtype == torch.bfloat16 and (B, T, H, D) \
                    == FLASH_XL_SHAPE[:4]:
                main[name + "_xl"] = row
            if dtype == torch.bfloat16 and (B, T, D, causal) \
                    == RL_FLASH_SHAPES[0]:
                main[name + "_rl"] = row
            if (B, T, H, D, causal) == FLASH_TINY_SHAPES[0]:
                main[name + ("_tiny" if dtype == torch.bfloat16
                             else "_tiny_f32")] = row
            pair_ms[name] = ms
            emit(row)
        # K2 + K3 beside the one library call that computes all of
        # dq, dk and dv
        emit({"kernel": "flash_dq+flash_dkv", "dtype": dn,
              "shape": {"B": B, "T": T, "H": H, "D": D,
                        "causal": causal},
              "kernel_ms": pair_ms["flash_dq"] + pair_ms["flash_dkv"],
              "library_ms": lib_ms,
              "library_source": "torch.profiler device time of the "
                                "kernels of SDPA's backward"})
    return main


# ------------------------------------------------------------ phase 3


def drain(stream, first_at: dict, counts: dict, now: float) -> None:
    """Take every event the stream holds without blocking."""
    while True:
        try:
            ev = stream.next_event(timeout=0)
        except TimeoutError:
            return
        if ev is None:
            return
        first_at.setdefault(stream.seq_id, now)
        counts[stream.seq_id] = counts.get(stream.seq_id, 0) + 1


def serve(torch, engine, prompts, max_tokens: int) -> dict:
    """Submit every prompt at once (greedy, `max_tokens` each) and step
    the engine until all finish: the finals, the token events per
    request, TTFT (ms from submission to the first token event), the
    wall time and the step times by kind of work, as the engine's own
    step histogram (serve_llm_step_ms, tagged by kind) times them; an
    idle step adds to neither. Fails if the engine makes no progress in
    600 s."""
    from ray_tpu_torch.serve.llm import SamplingParams

    step_hist = engine._m_step
    t_submit = time.perf_counter()
    streams = [engine.add_request(p, SamplingParams(max_tokens=max_tokens))
               for p in prompts]
    first_at: dict = {}
    counts: dict = {}
    steps = 0
    step_ms: dict[str, list[float]] = {"prefill": [], "decode": []}
    deadline = t_submit + 600
    while any(s.final() is None for s in streams):
        before = step_hist.sums_by_tag("kind")
        engine.step()
        steps += 1
        now = time.perf_counter()
        for kind, total in step_hist.sums_by_tag("kind").items():
            if total != before.get(kind, 0.0):
                step_ms[kind].append(total - before.get(kind, 0.0))
        for s in streams:
            drain(s, first_at, counts, now)
        if now > deadline:
            fail(f"engine made no progress in 600 s ({steps} steps)")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_submit
    for s in streams:
        drain(s, first_at, counts, time.perf_counter())
    finals = [s.final() for s in streams]
    for p, s, f in zip(prompts, streams, finals):
        if str(f["finish_reason"]).startswith("error"):
            fail(f"request of {len(p)} tokens: {f['finish_reason']}")
        if f["finish_reason"] != "length" \
                or f["num_generated"] != max_tokens \
                or len(f["token_ids"]) != max_tokens \
                or counts.get(s.seq_id) != max_tokens:
            fail(f"request of {len(p)} tokens: {f['finish_reason']}, "
                 f"{f['num_generated']} generated, "
                 f"{counts.get(s.seq_id)} token events")
    ttft = sorted((first_at[s.seq_id] - t_submit) * 1e3 for s in streams)
    n_tokens = sum(f["num_generated"] for f in finals)
    return {"finals": finals, "wall_s": wall, "steps": steps,
            "tokens": n_tokens, "tokens_per_s": n_tokens / wall,
            "ttft_ms_p50": float(np.median(ttft)), "ttft_ms_max": ttft[-1],
            "step_ms": {k: {"n": len(v), "p50": float(np.median(v)),
                            "max": max(v)} for k, v in step_ms.items() if v}}


def check_drained(engine, what: str) -> None:
    st = engine.stats()
    if st["blocks_used"] != 0 or st["running"] or st["waiting"]:
        fail(f"{what}: pool not drained: {st['blocks_used']} blocks used, "
             f"{st['running']} running, {st['waiting']} waiting")


def decode_consistency(torch, engine, prompt, gen, prefill_fn,
                       chunk: int = 0) -> dict:
    """Decode logits of one request (prefill, then one decode step per
    generated token, through the engine's own runner: its decode path,
    paged or dense) held against one fresh monolithic prefill over the
    same tokens (prefill_fn, through K1) at the same positions, within
    LOGITS_TOL. With `chunk` the request prefills in chunks of that many
    tokens, as the engine does a long prompt."""
    from ray_tpu_torch.serve.llm.runner import DecodeItem

    runner, pool = engine.runner, engine.pool
    table = pool.alloc(pool.blocks_for_tokens(len(prompt) + len(gen)))
    if chunk:
        for start in range(0, len(prompt), chunk):
            _, last = runner.prefill_chunk(prompt[start:start + chunk],
                                           start, table, 0.0)
    else:
        _, last = runner.prefill(prompt, table, 0.0)
    rows = [last]
    for i in range(1, len(gen)):
        _, lg = runner.decode(
            [DecodeItem(gen[i - 1], len(prompt) + i - 1, table, 0.0)])
        rows.append(lg[0])
    pool.free(table)
    full = torch.tensor([prompt + gen[:-1]], device="cuda")
    with torch.no_grad():
        ref, _, _ = prefill_fn(runner._compute, full, engine.model_cfg)
    vocab = engine.model_cfg.vocab_size
    ref = ref[0, len(prompt) - 1:].cpu().numpy()[:, :vocab]
    got = np.stack(rows)[:, :vocab]
    diff = np.abs(got - ref)
    out = {"rows": len(rows), "max_abs": float(diff.max()),
           "mean_abs": float(diff.mean()),
           "argmax_agree": int((got.argmax(-1) == ref.argmax(-1)).sum()),
           "tol": LOGITS_TOL}
    if not (np.isfinite(got).all() and diff.max() <= LOGITS_TOL["max_abs"]
            and diff.mean() <= LOGITS_TOL["mean_abs"]):
        fail(f"{engine.config.model} decode logits vs prefill: {out}")
    return out


def launch_counts(counters) -> dict:
    """The counters' launches, and K4's by window and heads."""
    out = {k: c.count for k, c in counters.items()}
    out["paged_attention_by_shape"] = dict(
        counters["paged_attention"].by_shape)
    return out


def release(torch) -> None:
    """Give a deleted engine's memory (its pool is 0.3 of the card) back
    before the next one is built."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_engine(torch, keep: dict | None = None) -> dict:
    """GPT-2-small on the paged engine: monolithic prefill (K1), paged
    decode (K4). Returns its row; its prompts and streams go into `keep`
    (serve_gpt2's reference)."""
    from ray_tpu_torch.models.gpt2 import gpt2_prefill_kv
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    t0 = time.perf_counter()
    engine = LLMEngine(EngineConfig(
        model="gpt2", preset="small", block_size=16, max_model_len=1024,
        max_batch_size=8, prefill_chunk_size=0, use_paged_attention=True,
        speculative=None, seed=0))
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shapes = engine.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    prompts = engine_prompts(engine.model_cfg.vocab_size, 0)
    torch.cuda.reset_peak_memory_stats()
    counters = _reset_counters()
    run = serve(torch, engine, prompts, MAX_TOKENS)
    launches = launch_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    for name in ("flash_fwd", "paged_attention"):
        if launches[name] <= 0:
            fail(f"{name} was not launched on the main path")
    check_drained(engine, "engine")
    finals = run.pop("finals")
    if keep is not None:
        keep.update(prompts=prompts,
                    streams=[f["token_ids"] for f in finals])
    consistency = decode_consistency(torch, engine, prompts[0],
                                     finals[0]["token_ids"],
                                     gpt2_prefill_kv)
    profile = profile_engine(torch, engine, prompts)
    row = {"phase": "engine", "model": "gpt2-small",
           "dtype": dname(torch, engine.model_cfg.dtype),
           "requests": len(prompts), "prompt_lens": list(ENGINE_PROMPTS),
           "max_tokens": MAX_TOKENS, "num_blocks": engine.pool.num_blocks,
           "init_s": init_s, "warmup_s": warm_s, "warmup_shapes": shapes,
           **run, "max_memory_allocated": peak, "launches": launches,
           "consistency": consistency}
    emit(row)
    emit(profile)
    del engine
    release(torch)
    return row


def engine_prompts(vocab: int, seed: int) -> list[list[int]]:
    """Random prompts of the ENGINE_PROMPTS lengths."""
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).tolist() for n in ENGINE_PROMPTS]


def phase_engine_default(torch, paged_row: dict,
                         keep: dict | None = None) -> dict:
    """GPT-2-small at the JAX engine's defaults: chunked prefill at 256
    (prompts of at most one chunk prefill monolithically through K1),
    the prefix cache, dense decode. Wave 1 is the paged phase's requests;
    wave 2 shares the first 512 tokens of its 700-token prompt, which
    must come from the cache. Returns the launches of both waves; wave
    1's streams, launches and tokens/s, and the engine's compute-dtype
    params, go into `keep` (serve_mesh's reference)."""
    from ray_tpu_torch.models.gpt2 import gpt2_prefill_kv
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    t0 = time.perf_counter()
    engine = LLMEngine(EngineConfig(model="gpt2", preset="small",
                                    max_model_len=1024, max_batch_size=8,
                                    seed=0))
    cfg = engine.model_cfg
    chunk = engine.runner.prefill_chunk_size
    if not (chunk == 256 and engine.pool.enable_prefix_cache
            and not engine.runner.use_paged_attention
            and engine.runner.spec_width == 0):
        fail(f"engine_default: not the JAX defaults (chunk {chunk}, "
             f"prefix cache {engine.pool.enable_prefix_cache}, paged "
             f"{engine.runner.use_paged_attention})")
    shapes = engine.warmup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompts = engine_prompts(cfg.vocab_size, 0)

    counters = _reset_counters()
    wave1 = serve(torch, engine, prompts, MAX_TOKENS)
    launches1 = launch_counts(counters)
    mono = sum(1 for n in ENGINE_PROMPTS if n <= chunk)
    want = {"flash_fwd": mono * cfg.n_layer, "paged_attention": 0}
    got = {k: launches1[k] for k in want}
    if got != want:
        fail(f"engine_default wave 1: launches {got}, want {want} "
             f"({mono} monolithic prefills of {cfg.n_layer} layers)")
    check_drained(engine, "engine_default wave 1")

    rng = np.random.RandomState(1)
    shared = prompts[0][:SHARED_PREFIX]
    wave2_prompts = [shared + rng.randint(0, cfg.vocab_size,
                                          SUFFIX).tolist()
                     for _ in range(WAVE2)]
    hits0 = engine.stats()["prefix_hit_pages"]
    counters = _reset_counters()
    wave2 = serve(torch, engine, wave2_prompts, MAX_TOKENS)
    launches2 = launch_counts(counters)
    hits = engine.stats()["prefix_hit_pages"] - hits0
    want_hits = WAVE2 * SHARED_PREFIX // engine.pool.block_size
    if hits < want_hits:
        fail(f"engine_default wave 2: {hits} prefix-hit pages, want at "
             f"least {want_hits}")
    if launches2["paged_attention"] or launches2["flash_fwd"]:
        fail(f"engine_default wave 2: launches {launches2}; every prompt "
             f"starts past its cached prefix, so none is monolithic")
    check_drained(engine, "engine_default wave 2")
    cached = [f["cached_tokens"] for f in wave2["finals"]]

    f1 = wave1.pop("finals")
    wave2.pop("finals")
    if keep is not None:
        keep.update(streams=[f["token_ids"] for f in f1],
                    launches=launches1,
                    tokens_per_s=wave1["tokens_per_s"],
                    compute=engine.runner._compute)
    consistency = decode_consistency(torch, engine, prompts[0],
                                     f1[0]["token_ids"], gpt2_prefill_kv,
                                     chunk=chunk)
    profile = profile_engine(torch, engine,
                             engine_prompts(cfg.vocab_size, 2),
                             "engine_default_profile")
    row = {"phase": "engine_default", "model": "gpt2-small",
           "dtype": dname(torch, cfg.dtype),
           "config": "EngineConfig defaults: prefill_chunk_size=256, "
           "enable_prefix_cache=True, use_paged_attention=False",
           "num_blocks": engine.pool.num_blocks,
           "setup_s": setup_s, "warmup_shapes": shapes,
           "wave1": {"prompt_lens": list(ENGINE_PROMPTS), **wave1,
                     "launches": launches1},
           "wave2": {"prompt_lens": [len(p) for p in wave2_prompts],
                     **wave2, "prefix_hit_pages": hits,
                     "cached_tokens": cached, "launches": launches2},
           "paged_engine_same_requests": {
               k: paged_row[k] for k in ("tokens_per_s", "ttft_ms_p50",
                                         "ttft_ms_max", "step_ms")},
           "consistency_chunked_dense": consistency}
    emit(row)
    emit(profile)
    del engine
    release(torch)
    return {k: launches1[k] + launches2[k]
            for k in ("flash_fwd", "paged_attention")}  # K4: none


def phase_engine_spec(torch) -> dict:
    """GPT-2-small on the paged engine with speculative decoding (K=4):
    each drafted lane's window of 5 goes through K4 at W=5. Every
    committed token must be the argmax of a fresh prefill's logits row
    at its position, or within LOGITS_TOL["max_abs"] of it (a near-tie
    in bf16 may break either way). The same requests then run with
    speculation off. Returns the launches with speculation on."""
    from ray_tpu_torch.models.gpt2 import gpt2_prefill_kv
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    def build(spec):
        engine = LLMEngine(EngineConfig(
            model="gpt2", preset="small", max_model_len=1024,
            max_batch_size=8, prefill_chunk_size=0,
            use_paged_attention=True, speculative=spec, seed=0))
        engine.warmup()
        torch.cuda.synchronize()
        return engine

    engine = build({"num_draft_tokens": SPEC_K})
    cfg = engine.model_cfg
    rng = np.random.RandomState(0)
    prompts = []
    for _ in range(SPEC_REQUESTS):
        motif = rng.randint(0, cfg.vocab_size, SPEC_MOTIF).tolist()
        prompts.append((motif * (SPEC_PROMPT // SPEC_MOTIF))[:SPEC_PROMPT])
    counters = _reset_counters()
    run = serve(torch, engine, prompts, SPEC_TOKENS)
    launches = launch_counts(counters)
    # the engine verifies one lane at a time: every W=5 launch is S=1,
    # the shape of PAGED_PATH_ROWS["verify"]
    by_shape = launches["paged_attention_by_shape"]
    verify_launches = k4_launches(by_shape, SPEC_K + 1, cfg.n_head,
                                  cfg.n_head, S=1)
    if verify_launches <= 0 or verify_launches % cfg.n_layer \
            or verify_launches != k4_launches(by_shape, SPEC_K + 1,
                                              cfg.n_head, cfg.n_head):
        fail(f"engine_spec: {verify_launches} K4 launches at S=1 "
             f"W={SPEC_K + 1}: {launches}")
    st = engine.stats()
    if not 0 <= st["spec_accepted"] <= st["spec_proposed"]:
        fail(f"engine_spec: accepted {st['spec_accepted']} of "
             f"{st['spec_proposed']} proposed")
    check_drained(engine, "engine_spec")
    finals = run.pop("finals")
    streams = [f["token_ids"] for f in finals]
    ties, worst = argmax_gaps(torch, gpt2_prefill_kv,
                              engine.runner._compute, cfg, prompts, streams)
    if not worst <= LOGITS_TOL["max_abs"]:
        fail(f"engine_spec: a committed token's logit is {worst} below "
             f"its row's max (tol {LOGITS_TOL['max_abs']})")
    profile = profile_engine(torch, engine, prompts,
                             "engine_spec_profile")
    del engine
    release(torch)
    engine = build(None)
    off = serve(torch, engine, prompts, SPEC_TOKENS)
    same = sum(a == b["token_ids"] for a, b in zip(streams, off.pop("finals")))
    check_drained(engine, "engine_spec (speculation off)")
    del engine
    release(torch)
    row = {"phase": "engine_spec", "model": "gpt2-small",
           "dtype": dname(torch, cfg.dtype), "num_draft_tokens": SPEC_K,
           "requests": SPEC_REQUESTS, "prompt": f"{SPEC_MOTIF}-token motif "
           f"repeated to {SPEC_PROMPT} tokens", "max_tokens": SPEC_TOKENS,
           **run, "launches": launches,
           "verify_steps": verify_launches // cfg.n_layer,
           "spec_proposed": st["spec_proposed"],
           "spec_accepted": st["spec_accepted"],
           "accept_ratio": st["spec_accepted"] / max(1, st["spec_proposed"]),
           "tokens_not_argmax": ties, "max_gap_to_argmax": worst,
           "gap_tol": LOGITS_TOL["max_abs"],
           "spec_off": off, "streams_equal_to_spec_off": same}
    emit(row)
    emit(profile)
    return launches


def argmax_gaps(torch, prefill_fn, compute, cfg, prompts, streams):
    """The bf16 tie-aware check of committed tokens: each stream's
    tokens against one fresh prefill (K1) over prompt + stream, at their
    positions. Returns (tokens that are not their row's argmax, the
    largest gap from a row's max to the committed token's logit)."""
    ties, worst = 0, 0.0
    for prompt, gen in zip(prompts, streams):
        full = torch.tensor([prompt + gen[:-1]], device="cuda")
        with torch.no_grad():
            ref, _, _ = prefill_fn(compute, full, cfg)
        rows = ref[0, len(prompt) - 1:, :cfg.vocab_size].float()
        gap = rows.max(-1).values - rows.gather(
            -1, torch.tensor(gen, device="cuda")[:, None])[:, 0]
        ties += int((gap > 0).sum())
        worst = max(worst, float(gap.max()))
    return ties, worst


def phase_engine_llama(torch, keep: dict | None = None) -> dict:
    """Llama-small (12 layers, E=768, H=12 over H_kv=4, SwiGLU 2048,
    vocab 32000) in bf16 on the paged engine: prefill through K1 on K/V
    repeated to 12 heads, grouped-query decode through K4. Returns its
    launches; its streams, launches, tokens/s and compute-dtype params go
    into `keep` (serve_mesh's reference)."""
    from ray_tpu_torch.models.llama import llama_prefill_kv
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    t0 = time.perf_counter()
    engine = LLMEngine(EngineConfig(
        model="llama", preset="small", max_model_len=1024,
        max_batch_size=8, prefill_chunk_size=0, use_paged_attention=True,
        seed=0))
    engine.warmup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg = engine.model_cfg
    prompts = engine_prompts(cfg.vocab_size, 0)
    counters = _reset_counters()
    run = serve(torch, engine, prompts, MAX_TOKENS)
    launches = launch_counts(counters)
    if launches["flash_fwd"] != len(prompts) * cfg.n_layer \
            or k4_launches(launches["paged_attention_by_shape"], 1,
                           cfg.n_head, cfg.n_kv_head) <= 0:
        fail(f"engine_llama: launches {launches}, want "
             f"{len(prompts) * cfg.n_layer} flash_fwd and K4 at W=1 "
             f"H={cfg.n_head} H_kv={cfg.n_kv_head}")
    check_drained(engine, "engine_llama")
    finals = run.pop("finals")
    if keep is not None:
        keep.update(streams=[f["token_ids"] for f in finals],
                    launches=launches, tokens_per_s=run["tokens_per_s"],
                    compute=engine.runner._compute)
    consistency = decode_consistency(torch, engine, prompts[0],
                                     finals[0]["token_ids"],
                                     llama_prefill_kv)
    profile = profile_engine(torch, engine, prompts,
                             "engine_llama_profile")
    row = {"phase": "engine_llama", "model": "llama-small",
           "dtype": dname(torch, cfg.dtype), "shape": {
               "n_layer": cfg.n_layer, "n_embd": cfg.n_embd,
               "n_head": cfg.n_head, "n_kv_head": cfg.n_kv_head,
               "intermediate": cfg.intermediate,
               "vocab_size": cfg.vocab_size},
           "requests": len(prompts), "prompt_lens": list(ENGINE_PROMPTS),
           "max_tokens": MAX_TOKENS, "setup_s": setup_s, **run,
           "launches": launches, "consistency": consistency}
    emit(row)
    emit(profile)
    del engine
    release(torch)
    return launches


def kernel_class(name: str) -> str:
    for k in ("flash_fwd", "flash_dq", "flash_dkv"):
        if k + "_" in name:
            return k
    if "paged_kernel" in name:
        return "paged_attention"
    if any(s in name.lower() for s in ("gemm", "xmma", "cutlass", "gemv",
                                        "nvjet")):
        return "matmul"
    return "other"


def profile_engine(torch, engine, prompts, phase: str = "profile") -> dict:
    """Serve the same requests again under torch.profiler: device time
    by kernel class and the device's busy share of the wall time (the
    profiler's own cost slows the host side of this pass)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.serve.llm import SamplingParams

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        streams = [engine.add_request(p, SamplingParams(
            max_tokens=MAX_TOKENS)) for p in prompts]
        while any(s.final() is None for s in streams):
            engine.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = device_time(torch, prof, wall_us)
    out["phase"] = phase
    return out


# ------------------------------------------------------------ phase 5


def _launch_counters():
    """This process's launch counters by kernel name."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import paged_attention as pa

    return {"flash_fwd": fa.LAUNCHES, "flash_dq": fa.LAUNCHES_DQ,
            "flash_dkv": fa.LAUNCHES_DKV, "paged_attention": pa.LAUNCHES}


def _reset_counters():
    """Zero the launch counters and the count of layout copies; returns
    the launch counters by kernel name."""
    from ray_tpu_torch.ops import flash_attention as fa

    counters = _launch_counters()
    for c in counters.values():
        c.reset()
    fa.LAYOUT_COPIES.reset()
    return counters


def phase_train(torch, keep: dict | None = None) -> dict:
    """GPT-2-small training through the port's entry points: bf16
    compute, f32 masters, B=8 T=1024 random tokens (seed 0), one fixed
    batch, adamw(3e-4, weight_decay=0.1), remat on; TRAIN_WARMUP steps,
    then TRAIN_STEPS timed steps with the launch counters zeroed just
    before and read just after, then a few steps under torch.profiler.
    `keep`, if given, takes the step ms (phase 13 prints them beside
    its own)."""
    from ray_tpu_torch.models.gpt2 import (
        GPT2Config,
        count_params,
        gpt2_loss,
        init_gpt2,
    )
    from ray_tpu_torch.train import TrainState, adamw, make_train_step

    cfg = GPT2Config.small()
    B, T = TRAIN_BATCH
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_gpt2(gen, cfg)
    n_params = count_params(params)
    tx = adamw(3e-4, weight_decay=0.1)
    state = TrainState.create(params, tx)
    step = make_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx)
    toks = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    state, losses, norms, wall, step_ms, launches, copies, peak = \
        _train_steps(torch, step, state, batch, TRAIN_WARMUP, TRAIN_STEPS)
    row = {"phase": "train", "model": "gpt2-small", "dtype": "bfloat16",
           "masters": "float32", "batch": B, "seq": T, "remat": cfg.remat,
           "optimizer": "adamw(3e-4, weight_decay=0.1)", "init_s": init_s,
           "warmup_steps": TRAIN_WARMUP,
           **_train_row("train", n_params, B * T, TRAIN_STEPS, wall,
                        step_ms, launches, peak, losses, norms),
           "losses": losses, "grad_norm_first": norms[0],
           "grad_norm_last": norms[-1], "launches": launches,
           "layout_copies": copies}
    if not losses[-1] < losses[0]:
        fail(f"train: the loss on the fixed batch did not fall: "
             f"{losses[0]} -> {losses[-1]}")
    want = {"flash_fwd": 2 * cfg.n_layer, "flash_dq": cfg.n_layer,
            "flash_dkv": cfg.n_layer, "paged_attention": 0}
    if row["launches_per_step"] != want:
        fail(f"train: launches per step {row['launches_per_step']}, want "
             f"{want}")
    if copies:
        fail(f"train: {copies} q, k or v copied to fix its layout")
    if state.step != TRAIN_WARMUP + TRAIN_STEPS:
        fail(f"train: state.step {state.step}")

    profile = profile_train(torch, step, state, batch)
    emit(row)
    emit(profile)
    if keep is not None:
        keep["step_ms"] = row["step_ms"]
        keep["observe"] = (step, state, batch)  # phase 20 (b)
    return launches


def profile_train(torch, step, state, batch,
                  steps: int = PROFILE_STEPS) -> dict:
    """`steps` more train steps under torch.profiler, tracing the device
    only (tracing the host's operator calls as well more than doubles
    the step's wall time): device time by kernel class and per step, and
    the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = device_time(torch, prof, wall_us)
    out.update({"phase": "train_profile", "steps": steps,
                "step_wall_ms": wall_us / 1e3 / steps})
    if out["device_busy_ms"] != "not measured":
        out["device_ms_per_step"] = out["device_busy_ms"] / steps
    return out


def device_time(torch, prof, wall_us: float) -> dict:
    """Device time by kernel class and busy share from a profile."""
    by_class: dict[str, float] = {}
    by_name: dict[str, float] = {}
    launches = 0
    for ev in prof.key_averages():
        us = device_us(ev)
        if us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_class[kernel_class(ev.key)] = \
            by_class.get(kernel_class(ev.key), 0.0) + us
        by_name[ev.key[:80]] = by_name.get(ev.key[:80], 0.0) + us
        launches += ev.count
    busy = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3,
            "device_kernel_launches": launches,
            "device_busy_ms": busy / 1e3 if busy else "not measured",
            "device_busy_share": busy / wall_us if busy else "not measured",
            "device_ms_by_class": {k: v / 1e3 for k, v in by_class.items()},
            "top_kernels_ms": {k: v / 1e3 for k, v in top}}


# ------------------------------------------------------------ phase 5b


def _train_steps(torch, step, state, batch, warmup: int, steps: int):
    """`warmup` steps, then `steps` timed steps with the launch counters
    zeroed just before and read just after: (state, losses, grad norms,
    wall s, step ms sorted, launches, layout copies, peak bytes)."""
    from ray_tpu_torch.ops import flash_attention as fa

    metrics = []
    for _ in range(warmup):
        state, m = step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _reset_counters()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(steps + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(steps):
        state, m = step(state, batch)
        metrics.append(m)
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    step_ms = sorted(events[i].elapsed_time(events[i + 1])
                     for i in range(steps))
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    return (state, losses, norms, wall, step_ms, launches,
            fa.LAYOUT_COPIES.count, torch.cuda.max_memory_allocated())


def _train_row(what: str, n_params: int, tokens: int, steps: int,
               wall: float, step_ms, launches: dict, peak: int,
               losses, norms) -> dict:
    """The numbers of a timed training run, its checks left to the
    caller: every loss and grad norm finite."""
    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"{what}: non-finite loss or grad norm: {losses} {norms}")
    tok_s = tokens * steps / wall
    return {"n_params": n_params, "steps": steps, "wall_s": wall,
            "tokens_per_s": tok_s,
            "step_ms": {"p50": step_ms[len(step_ms) // 2],
                        "max": step_ms[-1], "min": step_ms[0]},
            "mfu": 6.0 * n_params * tok_s / PEAK_FLOPS["bfloat16"],
            "mfu_formula": "6 N tokens/s / 989e12 (bf16 dense peak)",
            "max_memory_allocated": peak,
            "launches_per_step": {k: n / steps for k, n in launches.items()},
            "loss_first": losses[0], "loss_last": losses[-1]}


def phase_train_llama(torch) -> dict:
    """Llama-small (12 layers, E=768, H=12 over H_kv=4, SwiGLU 2048,
    vocab 32000) on bench.py's recipe: bf16 compute, f32 masters, B=8
    T=1024 random tokens (seed 0), one fixed batch, adamw(3e-4,
    weight_decay=0.1), full remat; TRAIN_WARMUP then LLAMA_STEPS timed
    steps, then a profile. K1 runs on K/V repeated to 12 heads; the
    launches must be exactly 24/12/12 a step and the loss must fall."""
    from ray_tpu_torch.models.gpt2 import count_params
    from ray_tpu_torch.models.llama import LlamaConfig, init_llama, llama_loss
    from ray_tpu_torch.train import TrainState, adamw, make_train_step

    cfg = LlamaConfig.small()
    B, T = TRAIN_BATCH
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_llama(gen, cfg)
    n_params = count_params(params)
    tx = adamw(3e-4, weight_decay=0.1)
    step = make_train_step(lambda p, b: llama_loss(p, b, cfg), tx)
    toks = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    state, losses, norms, wall, step_ms, launches, copies, peak = \
        _train_steps(torch, step, TrainState.create(params, tx), batch,
                     TRAIN_WARMUP, LLAMA_STEPS)
    row = {"phase": "train_llama", "model": "llama-small",
           "dtype": "bfloat16", "masters": "float32", "batch": B, "seq": T,
           "remat": cfg.remat, "optimizer": "adamw(3e-4, weight_decay=0.1)",
           **_train_row("train_llama", n_params, B * T, LLAMA_STEPS, wall,
                        step_ms, launches, peak, losses, norms),
           "losses": losses, "launches": launches, "layout_copies": copies}
    want = {"flash_fwd": 2 * cfg.n_layer, "flash_dq": cfg.n_layer,
            "flash_dkv": cfg.n_layer, "paged_attention": 0}
    if row["launches_per_step"] != want:
        fail(f"train_llama: launches per step {row['launches_per_step']}, "
             f"want {want}")
    if not losses[-1] < losses[0]:
        fail(f"train_llama: the loss on the fixed batch did not fall: "
             f"{losses[0]} -> {losses[-1]}")
    profile = profile_train(torch, step, state, batch)
    profile["phase"] = "train_llama_profile"
    emit(row)
    emit(profile)
    del state, step, params
    release(torch)
    return launches


def phase_remat(torch) -> dict:
    """Every RAY_TPU_REMAT_POLICY on GPT-2-small and on bench.py's
    XL-class config at B=8 T=1024 (bf16, f32 masters, adamw), from the
    same seeded params and batch: REMAT_WARMUP then REMAT_STEPS timed
    steps each, then a profiled step. K1 must launch 2 L times a step
    under "full" (the replay runs it again) and L times under the others
    (save_flash and save_dots keep its (o, lse), none keeps
    everything), K2 and K3 L times each; every step's loss and grad norm
    equal "full"'s within REMAT_TRAJ_RTOL. Returns the launches of every
    timed step."""
    from ray_tpu_torch.models.gpt2 import (
        GPT2Config,
        count_params,
        gpt2_loss,
        init_gpt2,
    )
    from ray_tpu_torch.train import TrainState, adamw, make_train_step

    B, T = TRAIN_BATCH
    total: dict = {}
    before = os.environ.get("RAY_TPU_REMAT_POLICY")
    try:
        for name, cfg in (("gpt2-small", GPT2Config.small()),
                          ("gpt2-xl-class", GPT2Config(**XL_CLASS))):
            rows = {}
            for policy in REMAT_POLICIES:
                os.environ["RAY_TPU_REMAT_POLICY"] = policy
                gen = torch.Generator(device="cuda")
                gen.manual_seed(0)
                params = init_gpt2(gen, cfg)
                n_params = count_params(params)
                tx = adamw(3e-4, weight_decay=0.1)
                step = make_train_step(lambda p, b, c=cfg: gpt2_loss(p, b, c),
                                       tx)
                toks = torch.randint(0, cfg.vocab_size, (B, T + 1),
                                     generator=gen, device="cuda")
                batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
                state, losses, norms, wall, step_ms, launches, _, peak = \
                    _train_steps(torch, step, TrainState.create(params, tx),
                                 batch, REMAT_WARMUP, REMAT_STEPS)
                row = _train_row(f"remat {name} {policy}", n_params, B * T,
                                 REMAT_STEPS, wall, step_ms, launches, peak,
                                 losses, norms)
                row["losses"], row["grad_norms"] = losses, norms
                L = cfg.n_layer
                want = {"flash_fwd": (2 if policy == "full" else 1) * L,
                        "flash_dq": L, "flash_dkv": L, "paged_attention": 0}
                if row["launches_per_step"] != want:
                    fail(f"remat {name} {policy}: launches per step "
                         f"{row['launches_per_step']}, want {want}")
                prof = profile_train(torch, step, state, batch, steps=1)
                row["profile"] = {k: prof[k] for k in (
                    "device_busy_share", "device_ms_by_class",
                    "step_wall_ms") if k in prof}
                row["device_ms_per_step"] = prof.get("device_ms_per_step",
                                                     "not measured")
                rows[policy] = row
                for k, n in launches.items():
                    total[k] = total.get(k, 0) + n
                del state, step, params, batch
                release(torch)
            want = rows["full"]
            worst = {}
            for policy, row in rows.items():
                worst[policy] = max(
                    abs(x - y) / abs(y)
                    for key in ("losses", "grad_norms")
                    for x, y in zip(row[key], want[key]))
                if worst[policy] > REMAT_TRAJ_RTOL:
                    fail(f"remat {name} {policy}: losses {row['losses']} "
                         f"and grad norms {row['grad_norms']} against "
                         f"full's {want['losses']} and {want['grad_norms']}"
                         f" (rtol {REMAT_TRAJ_RTOL})")
            first = {p: r["loss_first"] for p, r in rows.items()}
            emit({"phase": "remat", "model": name, "dtype": "bfloat16",
                  "masters": "float32", "batch": B, "seq": T,
                  "shape": {"n_layer": cfg.n_layer, "n_head": cfg.n_head,
                            "n_embd": cfg.n_embd},
                  "optimizer": "adamw(3e-4, weight_decay=0.1)",
                  "warmup_steps": REMAT_WARMUP, "first_step_losses": first,
                  "max_rel_diff_from_full": worst,
                  "rtol": REMAT_TRAJ_RTOL, "policies": rows})
    finally:
        if before is None:
            os.environ.pop("RAY_TPU_REMAT_POLICY", None)
        else:
            os.environ["RAY_TPU_REMAT_POLICY"] = before
    return total


# ------------------------------------------------------------ phase 5d


def _mesh_model(torch, model: str):
    """(cfg, init_fn, loss_fn, rules, batch) of GPT-2-small or
    Llama-small: init_fn draws the params on the card from a generator
    seeded 0, and the batch is the next B x (T + 1) tokens it draws, as
    phase_train makes them."""
    from ray_tpu_torch.models import gpt2, llama

    if model == "gpt2":
        cfg, init, loss, rules = (gpt2.GPT2Config.small(), gpt2.init_gpt2,
                                  gpt2.gpt2_loss,
                                  gpt2.gpt2_partition_rules())
    else:
        cfg, init, loss, rules = (llama.LlamaConfig.small(),
                                  llama.init_llama, llama.llama_loss,
                                  llama.llama_partition_rules())
    B, T = TRAIN_BATCH

    def init_fn():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        return init(gen, cfg), gen

    _, gen = init_fn()
    toks = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return (cfg, lambda: init_fn()[0], lambda p, b: loss(p, b, cfg), rules,
            batch)


def _mesh_train(torch, what: str, state, step, batch, warmup: int,
                steps: int, n_params: int, tokens: int):
    """Train steps through `_train_steps` (launch counters zeroed around
    the timed ones), then a profile: (the run's row, its state)."""
    state, losses, norms, wall, step_ms, launches, copies, peak = \
        _train_steps(torch, step, state, batch, warmup, steps)
    row = _train_row(what, n_params, tokens, steps, wall, step_ms,
                     launches, peak, losses, norms)
    prof = profile_train(torch, step, state, batch)
    row.update({"losses": losses, "grad_norms": norms,
                "launches": launches, "layout_copies": copies,
                "device_busy_share": prof["device_busy_share"],
                "device_ms_per_step": prof.get("device_ms_per_step",
                                               "not measured"),
                "profile_step_wall_ms": prof["step_wall_ms"]})
    return row, state


def _worst_rel(a: dict, b: dict) -> float:
    return max(abs(x - y) / abs(y) for key in ("losses", "grad_norms")
               for x, y in zip(a[key], b[key]))


def phase_mesh(torch, keep: dict | None = None) -> dict:
    """The mesh path on a one-rank NCCL process group: GPT-2-small
    through ``init_sharded_state`` and ``make_train_step(mesh=, rules=,
    zero_stage=)`` at each of MESH_STAGES, Llama-small at stage 3, and
    the plain step of each from the same params and batch. Every mesh
    step's K1/K2/K3 launches must be exactly 2 L / L / L (the kernels run
    on the local shard through local_map), no operand copied, and every
    step's loss and grad norm within MESH_RTOL of the plain step's.
    Prints per run tokens/s, step ms, device busy share, peak memory
    (of the steps, and of `init_sharded_state`, which makes the whole
    state before laying it out) and the collectives of one step
    (CommDebugMode). Returns the launches of the mesh runs' timed
    steps; `keep`, if given, takes GPT-2's stage-0 losses (warm-up steps
    first) and step ms, which phase 15's trainer is held against."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from ray_tpu_torch.models.gpt2 import count_params
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.ops import collective_op_counts
    from ray_tpu_torch.train import (
        TrainState,
        adamw,
        init_sharded_state,
        make_train_step,
    )

    B, T = TRAIN_BATCH
    total: dict = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = build_mesh(MeshSpec(data=1))
        for model, stages, warmup, steps in (
                ("gpt2", MESH_STAGES, MESH_WARMUP, MESH_STEPS),
                ("llama", (3,), 1, MESH_LLAMA_STEPS)):
            cfg, init_fn, loss_fn, rules, batch = _mesh_model(torch, model)
            tx = adamw(3e-4, weight_decay=0.1)
            params = init_fn()
            n_params = count_params(params)
            plain, state = _mesh_train(
                torch, f"mesh {model} plain",
                TrainState.create(params, tx), make_train_step(loss_fn, tx),
                batch, warmup, steps, n_params, B * T)
            del state, params
            release(torch)
            rows = {"plain": plain}
            for stage in stages:
                step = make_train_step(loss_fn, tx, mesh=mesh, rules=rules,
                                       zero_stage=stage)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                state = init_sharded_state(init_fn, tx, mesh, rules,
                                           zero_stage=stage)
                # the whole state made on the rank, then laid out
                init_peak = torch.cuda.max_memory_allocated()
                row, state = _mesh_train(
                    torch, f"mesh {model} zero{stage}", state, step, batch,
                    warmup, steps, n_params, B * T)
                with CommDebugMode() as comm:
                    step(state, batch)
                row["collectives_per_step"] = collective_op_counts(comm)
                row["init_peak_bytes"] = init_peak
                row["max_rel_diff_from_plain"] = _worst_rel(row, plain)
                L = cfg.n_layer
                want = {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
                        "paged_attention": 0}
                if row["launches_per_step"] != want:
                    fail(f"mesh {model} zero{stage}: launches per step "
                         f"{row['launches_per_step']}, want {want}")
                if row["layout_copies"]:
                    fail(f"mesh {model} zero{stage}: "
                         f"{row['layout_copies']} operands copied")
                if row["max_rel_diff_from_plain"] > MESH_RTOL:
                    fail(f"mesh {model} zero{stage}: losses "
                         f"{row['losses']} and grad norms "
                         f"{row['grad_norms']} against the plain step's "
                         f"{plain['losses']} and {plain['grad_norms']} "
                         f"(rtol {MESH_RTOL})")
                for k, n in row["launches"].items():
                    total[k] = total.get(k, 0) + n
                rows[f"zero{stage}"] = row
                if keep is not None and model == "gpt2" and stage == 0:
                    keep.update(losses=row["losses"],
                                step_ms=row["step_ms"])
                del state, step
                release(torch)
            emit({"phase": "mesh", "model": f"{model}-small", "world": 1,
                  "backend": "nccl", "mesh": dict(zip(
                      mesh.mesh_dim_names, mesh.mesh.shape)),
                  "dtype": "bfloat16", "masters": "float32", "batch": B,
                  "seq": T, "optimizer": "adamw(3e-4, weight_decay=0.1)",
                  "warmup_steps": warmup, "rtol": MESH_RTOL, "runs": rows})
    finally:
        dist.destroy_process_group()
    return total


# ------------------------------------------------------------ phase 5c


def tiny_prompts(vocab: int, seed: int, motif: bool = False):
    """Random prompts of TINY_PROMPTS lengths, or (`motif`) an 8-token
    motif repeated to each length, which the n-gram proposer drafts
    from."""
    rng = np.random.RandomState(seed)
    if not motif:
        return [rng.randint(0, vocab, n).tolist() for n in TINY_PROMPTS]
    out = []
    for n in TINY_PROMPTS:
        m = rng.randint(0, vocab, 8).tolist()
        out.append((m * (n // 8 + 1))[:n])
    return out


def serve_checked(torch, engine, prompts, max_tokens: int, what: str,
                  prefill_fn) -> dict:
    """Serve `prompts` (every request must finish by length), check the
    pool drains and hold one request's decode logits against a fresh
    prefill; returns the run's numbers without its finals."""
    run = serve(torch, engine, prompts, max_tokens)
    check_drained(engine, what)
    finals = run.pop("finals")
    run["consistency"] = decode_consistency(
        torch, engine, prompts[0], finals[0]["token_ids"], prefill_fn)
    return run


def _add_launches(total: dict, launches: dict) -> dict:
    """Add a run's launches (and K4's by shape, if there) to `total`."""
    for k, v in launches.items():
        if isinstance(v, dict):
            into = total.setdefault(k, {})
            for shape, n in v.items():
                into[shape] = into.get(shape, 0) + n
        else:
            total[k] = total.get(k, 0) + v
    return total


def phase_tiny(torch) -> tuple[dict, dict]:
    """The tiny presets (head dim 32) on the card, and GPT-2-small on 64-
    and 128-token pages. For GPT-2 tiny and Llama tiny, each through
    ``LLMEngine(EngineConfig(model=m, preset="tiny"))``: the defaults,
    paged decode (K4 at D=32), paged decode with speculation (K4 at W=5),
    each serving TINY_PROMPTS with its logits held against a prefill;
    then TINY_TRAIN_STEPS train steps of the preset through K1-K3 at
    D=32. An engine whose verify window K4 cannot take must raise at
    construction, naming the window. Then GPT-2-small serves the
    engine phase's 8 prompts on 64- and on 128-token pages. Returns the
    launches of the tiny presets and of the large pages."""
    from ray_tpu_torch.models.gpt2 import (
        GPT2Config,
        gpt2_loss,
        gpt2_prefill_kv,
        init_gpt2,
    )
    from ray_tpu_torch.models.llama import (
        LlamaConfig,
        init_llama,
        llama_loss,
        llama_prefill_kv,
    )
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.train import TrainState, adamw, make_train_step

    tiny: dict = {}
    rows = {}
    for model, cfg, init, prefill_fn, loss_fn in (
            ("gpt2", GPT2Config.tiny(), init_gpt2, gpt2_prefill_kv,
             gpt2_loss),
            ("llama", LlamaConfig.tiny(), init_llama, llama_prefill_kv,
             llama_loss)):
        kv = getattr(cfg, "n_kv_head", cfg.n_head)
        for kind, over in (("defaults", {}),
                           ("paged", {"use_paged_attention": True}),
                           ("paged_spec", {"use_paged_attention": True,
                                           "speculative": {
                                               "num_draft_tokens": SPEC_K}})):
            engine = LLMEngine(EngineConfig(model=model, preset="tiny",
                                            **over))
            counters = _reset_counters()
            run = serve_checked(torch, engine,
                                tiny_prompts(cfg.vocab_size, 0,
                                             motif=kind == "paged_spec"),
                                TINY_TOKENS, f"tiny {model} {kind}",
                                prefill_fn)
            got = launch_counts(counters)
            _add_launches(tiny, got)
            if got["flash_fwd"] <= 0 or (got["paged_attention"] > 0) \
                    != (kind != "defaults"):
                fail(f"tiny {model} {kind}: launches {got}")
            if kind == "paged_spec":
                if k4_launches(got["paged_attention_by_shape"], SPEC_K + 1,
                               cfg.n_head, kv) <= 0:
                    fail(f"tiny {model} {kind}: no K4 launch at "
                         f"W={SPEC_K + 1}")
                st = engine.stats()
                run["spec_proposed"] = st["spec_proposed"]
                run["spec_accepted"] = st["spec_accepted"]
            rows[f"{model}_{kind}"] = {
                "dtype": dname(torch, engine.model_cfg.dtype),
                "head_dim": cfg.head_dim, **run, "launches": got}
            del engine
            release(torch)
        # train steps of the preset as it is (GPT-2 tiny in bf16 with
        # remat, Llama tiny in f32 without, as in JAX)
        B, T = TINY_TRAIN_BATCH
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = init(gen, cfg)
        tx = adamw(1e-3)
        step = make_train_step(lambda p, b, c=cfg, f=loss_fn: f(p, b, c), tx)
        toks = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen,
                             device="cuda")
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        _, losses, norms, _, step_ms, launches, _, _ = _train_steps(
            torch, step, TrainState.create(params, tx), batch, 0,
            TINY_TRAIN_STEPS)
        _add_launches(tiny, launches)
        per_step = {k: n / TINY_TRAIN_STEPS for k, n in launches.items()}
        L = cfg.n_layer
        want = {"flash_fwd": (2 if cfg.remat else 1) * L, "flash_dq": L,
                "flash_dkv": L, "paged_attention": 0}
        if per_step != want or not all(math.isfinite(x)
                                       for x in losses + norms):
            fail(f"tiny {model} train: launches per step {per_step} (want "
                 f"{want}), losses {losses}, grad norms {norms}")
        rows[f"{model}_train"] = {"dtype": dname(torch, cfg.dtype),
                                  "remat": cfg.remat, "batch": B, "seq": T,
                                  "losses": losses, "step_ms": step_ms,
                                  "launches_per_step": per_step}
        del params, step
        release(torch)

    # a verify window past K4's W <= 32 is refused when the engine is
    # built, not at its first step
    try:
        LLMEngine(EngineConfig(model="gpt2", preset="tiny",
                               use_paged_attention=True,
                               speculative={"num_draft_tokens": 40}))
    except ValueError as e:
        if "W=41" not in str(e):
            fail(f"tiny: the refusal does not name the window: {e}")
        rows["refused_at_construction"] = str(e)
    else:
        fail("tiny: an engine with 40 drafts and paged attention was built")
    release(torch)
    emit({"phase": "tiny", "prompt_lens": list(TINY_PROMPTS),
          "max_tokens": TINY_TOKENS, "runs": rows, "launches": tiny})

    # GPT-2-small's paged engine on 64- and 128-token pages
    large: dict = {}
    pages = {}
    for bs in (64, 128):
        engine = LLMEngine(EngineConfig(
            model="gpt2", preset="small", block_size=bs, max_model_len=1024,
            max_batch_size=8, prefill_chunk_size=0, use_paged_attention=True,
            speculative=None, seed=0))
        engine.warmup()
        counters = _reset_counters()
        run = serve_checked(torch, engine,
                            engine_prompts(engine.model_cfg.vocab_size, 0),
                            MAX_TOKENS, f"engine block_size={bs}",
                            gpt2_prefill_kv)
        got = launch_counts(counters)
        _add_launches(large, got)
        if k4_launches(got["paged_attention_by_shape"], 1, 12, 12) <= 0:
            fail(f"engine block_size={bs}: K4 was not launched: {got}")
        pages[bs] = {"num_blocks": engine.pool.num_blocks, **run,
                     "launches": got}
        del engine
        release(torch)
    emit({"phase": "engine_large_pages", "model": "gpt2-small",
          "prompt_lens": list(ENGINE_PROMPTS), "max_tokens": MAX_TOKENS,
          "by_block_size": pages, "launches": large})
    return tiny, large


# ------------------------------------------------------------ phase 6


def phase_parity(torch, model: str = "gpt2") -> dict:
    """One train step of GPT-2-small or Llama-small at full width in f32,
    B=1 T=256, from the same seeded params: on the card through the
    kernels, on the CPU through their plain versions. The loss, each
    leaf's gradient and each leaf's updated value must agree within
    PARITY_TOL."""
    import dataclasses

    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.train import TrainState, adamw, make_train_step
    from ray_tpu_torch.util import tree

    if model == "gpt2":
        cfg, init, loss_fn = gpt2.GPT2Config.small(), gpt2.init_gpt2, \
            gpt2.gpt2_loss
    else:
        cfg, init, loss_fn = llama.LlamaConfig.small(), llama.init_llama, \
            llama.llama_loss
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    B, T = PARITY_BATCH
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    params = {"cuda": init(gen, cfg)}
    params["cpu"] = tree.tree_map(lambda t: t.cpu(), params["cuda"])
    toks = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen,
                         device="cuda")
    counters = _reset_counters()
    loss, grads, stepped = {}, {}, {}
    t0 = time.perf_counter()
    for dev in ("cuda", "cpu"):
        batch = {"tokens": toks[:, :-1].to(dev),
                 "targets": toks[:, 1:].to(dev)}
        leaves = [t.detach().requires_grad_()
                  for t in tree.leaves(params[dev])]
        value = loss_fn(tree.unflatten(params[dev], leaves), batch, cfg)
        loss[dev] = float(value.detach())
        grads[dev] = [g.cpu() for g in torch.autograd.grad(value, leaves)]
        tx = adamw(3e-4, weight_decay=0.1)
        step = make_train_step(lambda p, b: loss_fn(p, b, cfg), tx)
        state, _ = step(TrainState.create(params[dev], tx), batch)
        stepped[dev] = [t.cpu() for t in tree.leaves(state.params)]
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
    copies = fa.LAYOUT_COPIES.count
    names = [path for path, _ in _paths(params["cpu"])]
    if abs(loss["cuda"] - loss["cpu"]) > PARITY_TOL["loss"]:
        fail(f"parity {model}: loss {loss['cuda']} on the card, "
             f"{loss['cpu']} on the CPU (tol {PARITY_TOL['loss']})")
    rows = {}
    for name, gc, gp, pc, pp in zip(names, grads["cuda"], grads["cpu"],
                                    stepped["cuda"], stepped["cpu"]):
        g_err = (gc - gp).abs().max().item()
        g_tol = PARITY_TOL["grad_rel"] * gp.abs().max().item()
        p_err = (pc - pp).abs().max().item()
        rows[name] = {"grad_err": g_err, "grad_tol": g_tol,
                      "param_err": p_err, "param_tol": PARITY_TOL["param"]}
        if not (g_err <= g_tol and p_err <= PARITY_TOL["param"]):
            fail(f"parity {model}: {name}: grad err {g_err} (tol {g_tol}), "
                 f"updated param err {p_err} (tol {PARITY_TOL['param']})")
    for k in ("flash_fwd", "flash_dq", "flash_dkv"):
        if launches[k] <= 0:
            fail(f"parity {model}: {k} was not launched on the card")
    row = {"phase": "parity", "model": f"{model}-small", "dtype": "float32",
           "batch": B, "seq": T, "seconds": time.perf_counter() - t0,
           "loss_cuda": loss["cuda"], "loss_cpu": loss["cpu"],
           "loss_tol": PARITY_TOL["loss"], "launches": launches,
           "layout_copies": copies, "leaves": rows}
    emit(row)
    return row


# ------------------------------------------------------------ phase 8


def even_share(prompt: list[int], tokens: list[int]) -> float:
    """The rl phases' reward: the share of generated token ids that are
    even. DigitSumTask's own reward is almost always 0 on random weights
    over 50,304 tokens, which would make every GRPO advantage 0 and the
    update a zero step; this one varies within each group."""
    del prompt
    return sum(1 for t in tokens if t % 2 == 0) / max(1, len(tokens))


def _rl_setup(torch, model: str, paged: bool = False):
    """A learner from a card generator seeded 0 (LLMLearnerConfig()'s
    JAX defaults), an engine at the JAX engine's defaults built from its
    get_weights(), a RolloutWorker and a flywheel that swaps with probes
    in flight; each lap's RL_PROMPTS DigitSumTask prompts are drawn from
    a RandomState seeded with the lap."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.rllib.llm import (
        DigitSumTask,
        FlywheelConfig,
        LLMLearner,
        LLMLearnerConfig,
        RLFlywheel,
        RolloutConfig,
        RolloutWorker,
    )
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine

    cfg = GPT2Config.small() if model == "gpt2" else LlamaConfig.small()
    learner = LLMLearner(model, cfg, config=LLMLearnerConfig())
    w0 = learner.get_weights()
    engine = LLMEngine(EngineConfig(model=model, preset="small",
                                    use_paged_attention=paged), params=w0)
    worker = RolloutWorker(engine=engine, reward_fn=even_share,
                           config=RolloutConfig(group_size=RL_GROUP,
                                                max_tokens=RL_TOKENS,
                                                temperature=1.0))
    task = DigitSumTask(prefix_len=RL_PREFIX)

    def prompt_fn(lap: int) -> list[list[int]]:
        rng = np.random.RandomState(lap)
        return [task.make_prompt(int(a), int(b))
                for a, b in rng.randint(0, 10, (RL_PROMPTS, 2))]

    fly = RLFlywheel(worker, learner, prompt_fn,
                     FlywheelConfig(swap_during_rollout=True))
    return learner, engine, fly, w0


def _rl_watch(learner, counters) -> list[dict]:
    """Record, for each call of the learner's update and publish_weights,
    its host seconds, the launch counts before and after, and update's
    trajectories; returns the log the calls append to."""
    log: list[dict] = []

    def watched(name, fn):
        def call(*args):
            before = {k: c.count for k, c in counters.items()}
            t0 = time.perf_counter()
            out = fn(*args)
            log.append({"call": name, "t0": t0,
                        "seconds": time.perf_counter() - t0,
                        "before": before,
                        "after": {k: c.count for k, c in counters.items()},
                        "args": args})
            return out
        return call

    learner.update = watched("update", learner.update)
    learner.publish_weights = watched("publish", learner.publish_weights)
    return log


def _rl_laps(torch, what: str, learner, engine, fly, laps: int,
             paged: bool = False) -> tuple[dict, list]:
    """`laps` flywheel laps with the launch counters zeroed just before
    and read just after, each lap checked: 32 trajectories kept, the
    swap's version the learner's, no probe dropped and one at least in
    flight, a finite loss and a grad norm above 0, K1 at least L times in
    the rollout and exactly 2 L / L / L (full remat) in the update.
    Returns (row, each lap's trajectories)."""
    L = learner.cfg.n_layer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _reset_counters()
    log = _rl_watch(learner, counters)
    laps_out, trajs = [], []
    t_start = time.perf_counter()
    for lap in range(laps):
        start = {k: c.count for k, c in counters.items()}
        t0 = time.perf_counter()
        m = fly.iteration()
        upd, pub = log[-2], log[-1]
        trajs.append(upd["args"][0])
        rollout = {k: upd["before"][k] - start[k] for k in start}
        update = {k: upd["after"][k] - upd["before"][k] for k in start}
        swap = m["swap"]
        row = {"lap": lap + 1, "loss": m["loss"],
               "grad_norm": m["grad_norm"], "kept": m["kept"],
               "version": m["version"], "reward_mean": m["reward_mean"],
               "rollout_tokens": m["rollout_tokens"],
               "rollout_s": upd["t0"] - t0,
               "rollout_tokens_per_s": m["rollout_tokens"]
               / (upd["t0"] - t0),
               "update_ms": upd["seconds"] * 1e3,
               "get_weights_ms": pub["seconds"] * 1e3,
               "swap_ms": swap["swap_seconds"] * 1e3,
               "lap_s": m["iteration_seconds"],
               "in_flight_streams": swap["in_flight_streams"],
               "probe_dropped": swap["probe_dropped"],
               "probe_stale": swap["probe_stale"],
               "rollout_launches": rollout, "update_launches": update}
        laps_out.append(row)
        want = {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
                "paged_attention": 0}
        bad = []
        if m["kept"] != RL_PROMPTS * RL_GROUP:
            bad.append(f"kept {m['kept']}")
        if not swap["version"] == m["version"] == lap + 1:
            bad.append(f"versions {swap['version']}, {m['version']}")
        if swap["probe_dropped"] or swap["in_flight_streams"] < 1:
            bad.append(f"probes {swap}")
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            bad.append(f"loss {m['loss']}, grad norm {m['grad_norm']}")
        if rollout["flash_fwd"] < L:
            bad.append(f"rollout K1 launches {rollout['flash_fwd']}")
        if update != want:
            bad.append(f"update launches {update}, want {want}")
        if bad:
            fail(f"{what} lap {lap + 1}: {'; '.join(bad)}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts(counters)
    del learner.update, learner.publish_weights  # the class's own again
    stats = engine.stats()
    if stats["weight_version"] != laps:
        fail(f"{what}: engine at weight version {stats['weight_version']}")
    hits, misses = stats["prefix_hit_pages"], stats["prefix_miss_pages"]
    if hits <= 0:
        fail(f"{what}: no prefix-cache hit")
    if paged and k4_launches(launches["paged_attention_by_shape"], 1, 12,
                             engine.runner.adapter.kv_heads(
                                 engine.model_cfg)) <= 0:
        fail(f"{what}: K4 was not launched at W=1")
    if not paged and launches["paged_attention"]:
        fail(f"{what}: K4 launched on the dense path")

    def spread(key):
        xs = sorted(r[key] for r in laps_out)
        return {"p50": xs[len(xs) // 2], "max": xs[-1], "min": xs[0]}

    row = {"phase": what, "model": f"{learner.model}-small",
           "dtype": "bfloat16", "masters": "float32", "laps": laps,
           "prompts_per_lap": RL_PROMPTS, "group_size": RL_GROUP,
           "max_tokens": RL_TOKENS, "prompt_len": RL_PREFIX + 2,
           "paged_attention": paged, "wall_s": wall,
           "rollout_tokens_per_s": spread("rollout_tokens_per_s"),
           "update_ms": spread("update_ms"), "swap_ms": spread("swap_ms"),
           "get_weights_ms": spread("get_weights_ms"),
           "get_weights_bytes": 4 * sum(
               t.numel() for _, t in _paths(learner.state.params)),
           "lap_s": spread("lap_s"), "prefix_hit_pages": hits,
           "prefix_miss_pages": misses,
           "prefix_hit_ratio": hits / max(1, hits + misses),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": launches, "per_lap": laps_out}
    return row, trajs


def _rl_logprob_contract(learner, trajs, w0, what: str,
                         version: int = 0) -> dict:
    """Trajectories' engine logprobs (bf16 prefill and decode), each at
    weight `version`, against the learner's teacher-forced forward at
    that version's params `w0` (None: the learner's own), held to
    LOGITS_TOL."""
    diffs = []
    for t in trajs:
        if t.stale or t.weight_version != version:
            fail(f"{what}: a trajectory at version {t.weight_version}, "
                 f"stale {t.stale}; want version {version}")
        got = learner.teacher_forced_logprobs(t, params=w0)
        diffs.append(np.abs(got - np.asarray(t.logprobs)))
    d = np.concatenate(diffs)
    out = {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
           "tokens": int(d.size), "tol": LOGITS_TOL}
    if not (out["max_abs"] <= LOGITS_TOL["max_abs"]
            and out["mean_abs"] <= LOGITS_TOL["mean_abs"]):
        fail(f"{what}: rollout logprobs against teacher-forced {out}")
    return out


def _rl_profiled_update(torch, learner, trajs) -> dict:
    """One more update under torch.profiler (device activity only)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        learner.update(trajs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = device_time(torch, prof, wall_us)
    out["phase"] = "rl_update_profile"
    return out


def _rl_policy_moves(torch) -> dict:
    """One update of a fresh GPT-2-small learner on a constructed group
    of two completions of one prompt, one rewarded and one not (the JAX
    test's): the rewarded token's log-prob margin must grow."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.rllib.llm import LLMLearner, LLMLearnerConfig
    from ray_tpu_torch.rllib.llm import Trajectory

    learner = LLMLearner("gpt2", GPT2Config.small(),
                         config=LLMLearnerConfig())
    prompt, good, bad = [20, 21, 22, 5, 7], [9], [3]

    def lp(tokens):
        t = Trajectory(prompt, tokens, [0.0], 0.0, 0, [0], False, 0, 1.0)
        return float(learner.teacher_forced_logprobs(t)[0])

    def mk(tokens, r):
        return Trajectory(prompt, tokens, [lp(tokens)], r, 0, [0], False,
                          0, 1.0)

    before = lp(good) - lp(bad)
    m = learner.update([mk(good, 1.0), mk(bad, 0.0)])
    after = lp(good) - lp(bad)
    out = {"margin_before": before, "margin_after": after,
           "loss": m["loss"], "grad_norm": m["grad_norm"]}
    if not after > before:
        fail(f"rl policy: the update did not prefer the rewarded token: "
             f"{out}")
    del learner
    release(torch)
    return out


def _rl_mesh(torch, trajs) -> dict:
    """The learner on a one-rank NCCL mesh (data=1) beside the plain
    learner, from the same params and trajectories: RL_MESH_UPDATES
    updates each (the first pays DTensor's first dispatch of each
    operator, the second is timed warm), every loss and grad norm within
    MESH_RTOL, each mesh update's launches exactly 24/12/12."""
    import torch.distributed as dist

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.rllib.llm import LLMLearner

    cfg = GPT2Config.small()
    params = LLMLearner("gpt2", cfg).get_weights()
    release(torch)
    out = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = build_mesh(MeshSpec(data=1))
        for name, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
            learner = LLMLearner("gpt2", cfg, params=params, **kw)
            torch.cuda.synchronize()
            counters = _reset_counters()
            runs = []
            for _ in range(RL_MESH_UPDATES):
                t0 = time.perf_counter()
                m = learner.update(trajs)
                torch.cuda.synchronize()
                runs.append({"loss": m["loss"], "grad_norm": m["grad_norm"],
                             "update_ms": (time.perf_counter() - t0) * 1e3})
            out[name] = {"updates": runs,
                         "launches": {k: c.count
                                      for k, c in counters.items()}}
            del learner
            release(torch)
    finally:
        dist.destroy_process_group()
    L, n = cfg.n_layer, RL_MESH_UPDATES
    want = {"flash_fwd": 2 * L * n, "flash_dq": L * n, "flash_dkv": L * n,
            "paged_attention": 0}
    if out["mesh"]["launches"] != want:
        fail(f"rl_mesh: launches {out['mesh']['launches']}, want {want}")
    rel = max(abs(a[k] - b[k]) / abs(b[k])
              for a, b in zip(out["mesh"]["updates"],
                              out["plain"]["updates"])
              for k in ("loss", "grad_norm"))
    out["max_rel_diff"] = rel
    if not rel <= MESH_RTOL:
        fail(f"rl_mesh: {out} (rtol {MESH_RTOL})")
    return out


def phase_rl(torch, card: str) -> dict:
    """GRPO through ray_tpu_torch.rllib.llm on the card: RL_LAPS laps of
    GPT-2-small at the JAX engine's defaults, the bf16 logprob contract,
    a profiled update, the policy-moves check, one paged lap (K4), one
    Llama-small lap and the learner on a one-rank mesh. Returns the
    launches of the "rl", "rl_paged", "rl_llama" and "rl_mesh" paths."""
    paths = {}
    learner, engine, fly, w0 = _rl_setup(torch, "gpt2")
    row, trajs = _rl_laps(torch, "rl", learner, engine, fly, RL_LAPS)
    paths["rl"] = row["launches"]
    row["logprob_contract"] = _rl_logprob_contract(learner, trajs[0], w0,
                                                   "rl")
    row["card"] = card
    profile = _rl_profiled_update(torch, learner, trajs[-1])
    row["update_device_ms"] = profile["device_busy_ms"]
    emit(row)
    emit(profile)
    del learner, engine, fly
    release(torch)
    emit({"phase": "rl_policy", "card": card, **_rl_policy_moves(torch)})

    for what, model, paged in (("rl_paged", "gpt2", True),
                               ("rl_llama", "llama", False)):
        learner, engine, fly, w0 = _rl_setup(torch, model, paged)
        row, lap_trajs = _rl_laps(torch, what, learner, engine, fly, 1,
                                  paged)
        paths[what] = row["launches"]
        row["logprob_contract"] = _rl_logprob_contract(
            learner, lap_trajs[0], w0, what)
        row["card"] = card
        emit(row)
        del learner, engine, fly
        release(torch)

    mesh = _rl_mesh(torch, trajs[0])
    paths["rl_mesh"] = mesh["mesh"]["launches"]
    emit({"phase": "rl_mesh", "card": card, "world": 1, "backend": "nccl",
          "rtol": MESH_RTOL, **mesh})
    return paths


# ------------------------------------------------------------ phase 9


@contextlib.contextmanager
def one_rank_nccl():
    """A process group of this one rank over NCCL, destroyed on the way
    out."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def events_ms(torch, fn, iters: int = MESH_TIME_ITERS) -> float:
    """Mean milliseconds per call of `fn` over `iters` calls after one
    warm call, between CUDA events: these calls run collectives and
    DTensor dispatch, which a CUDA graph would not capture."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_serve_mesh(torch, gpt2_ref: dict, llama_ref: dict) -> dict:
    """``LLMEngine(mesh=)`` on a one-rank NCCL ``tensor`` mesh: GPT-2-small
    at EngineConfig()'s defaults and Llama-small paged, each on the
    requests of engine_default and engine_llama, whose plain engines in
    this run give the reference (`gpt2_ref`, `llama_ref`): K1 and K4
    launches equal to the plain engine's (the kernels on each rank's
    heads, through local_map), the streams identical or else within the
    bf16 tie-aware check against a prefill of the plain engine's params
    off the mesh, the pool drained, tokens/s beside the plain engine's,
    and the collectives of one decode step. GPT-2 then takes an
    ``update_weights`` of seeded perturbed params, which must lay them
    out on the mesh again and serve other streams than before, equal to
    those of a plain engine built on the same perturbed params (or
    within the same tie-aware check against it). Returns the launches
    by path."""
    from torch.distributed.tensor.debug import CommDebugMode

    from ray_tpu_torch.models.gpt2 import gpt2_prefill_kv
    from ray_tpu_torch.models.llama import llama_prefill_kv
    from ray_tpu_torch.parallel.mesh import build_mesh
    from ray_tpu_torch.parallel.ops import collective_op_counts
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.serve.llm.runner import DecodeItem

    paths = {}
    with one_rank_nccl():
        mesh = build_mesh({"tensor": 1})
        for name, model, ref, prefill_fn, kw in (
                ("serve_mesh", "gpt2", gpt2_ref, gpt2_prefill_kv, {}),
                ("serve_mesh_llama", "llama", llama_ref, llama_prefill_kv,
                 {"prefill_chunk_size": 0, "use_paged_attention": True})):
            t0 = time.perf_counter()
            engine = LLMEngine(EngineConfig(
                model=model, preset="small", max_model_len=1024,
                max_batch_size=8, seed=0, **kw), mesh=mesh)
            engine.warmup()
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            cfg, runner = engine.model_cfg, engine.runner
            prompts = engine_prompts(cfg.vocab_size, 0)
            counters = _reset_counters()
            run = serve(torch, engine, prompts, MAX_TOKENS)
            launches = launch_counts(counters)
            check_drained(engine, name)
            streams = [f["token_ids"] for f in run.pop("finals")]
            keys = ("flash_fwd", "paged_attention", "paged_attention_by_shape")
            got = {k: launches[k] for k in keys}
            want = {k: ref["launches"][k] for k in keys}
            if got != want or not got["flash_fwd"] \
                    or bool(got["paged_attention"]) != (model == "llama"):
                fail(f"{name}: launches {got}, the plain engine's {want}")
            same = streams == ref["streams"]
            ties = worst = None
            if not same:
                ties, worst = argmax_gaps(torch, prefill_fn, ref["compute"],
                                          cfg, prompts, streams)
                if not worst <= LOGITS_TOL["max_abs"]:
                    fail(f"{name}: streams differ from the plain engine's "
                         f"and a committed token's logit is {worst} below "
                         f"its row's max (tol {LOGITS_TOL['max_abs']})")
            null_table = [0] * runner.max_blocks_per_seq
            with CommDebugMode() as comm:
                runner.decode([DecodeItem(1, 0, null_table, 0.0)])
            row = {"phase": name, "model": f"{model}-small", "world": 1,
                   "backend": "nccl", "mesh": {"tensor": 1},
                   "dtype": dname(torch, cfg.dtype),
                   "config": "EngineConfig defaults" if not kw else
                   "paged, monolithic prefill",
                   "pages_sharded_over_tensor": runner._shard_heads,
                   "num_blocks": engine.pool.num_blocks,
                   "setup_s": setup_s, **run, "launches": launches,
                   "plain_tokens_per_s": ref["tokens_per_s"],
                   "streams_identical_to_plain": same,
                   "tokens_not_argmax": ties, "max_gap_to_argmax": worst,
                   "gap_tol": LOGITS_TOL["max_abs"],
                   "collectives_one_decode_step":
                       collective_op_counts(comm)}
            paths[name] = launches
            if model == "gpt2":
                row["update_weights"] = swap_on_mesh(
                    torch, engine, mesh, kw, prompts, streams, launches,
                    prefill_fn)
                paths[name] = _add_launches(
                    dict(launches), row["update_weights"].pop("launches"))
            emit(row)
            del engine, runner
            release(torch)
    return paths


def swap_on_mesh(torch, engine, mesh, kw, prompts, streams, launches,
                 prefill_fn) -> dict:
    """serve_mesh's weight swap: ``update_weights`` of the mesh engine's
    params plus seeded noise (0.01 normal on every leaf), which must
    leave every param a DTensor on `mesh` and serve other streams than
    `streams` (the old weights'), with as many K1 launches, equal to
    those of a plain engine built on the same perturbed params in this
    run, or within the tie-aware check against that engine's prefill.
    Returns the swap's row, its launches under "launches"."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch import interop
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.util import tree

    rng = np.random.RandomState(9)
    new = tree.tree_map(
        lambda w: (w + 0.01 * rng.standard_normal(w.shape)).astype(w.dtype),
        interop.params_to_numpy(engine.runner.params))
    t0 = time.perf_counter()
    swap = engine.update_weights(1, new)
    swap_s = time.perf_counter() - t0
    off_mesh = [t for t in tree.leaves(engine.runner.params)
                if not (isinstance(t, DTensor) and t.device_mesh is mesh)]
    if off_mesh:
        fail(f"serve_mesh: after update_weights {len(off_mesh)} params "
             f"are not DTensors on the mesh")
    counters = _reset_counters()
    again = serve(torch, engine, prompts, MAX_TOKENS)
    relaunch = launch_counts(counters)
    check_drained(engine, "serve_mesh after update_weights")
    got = [f["token_ids"] for f in again.pop("finals")]
    if got == streams:
        fail("serve_mesh: after update_weights of perturbed params the "
             "streams are the old weights'")
    if relaunch["flash_fwd"] != launches["flash_fwd"]:
        fail(f"serve_mesh: after update_weights K1 launched "
             f"{relaunch['flash_fwd']} times, first {launches['flash_fwd']}")
    plain = LLMEngine(EngineConfig(
        model="gpt2", preset="small", max_model_len=1024, max_batch_size=8,
        seed=0, **kw), params=new)
    plain.warmup()
    want = [f["token_ids"] for f in
            serve(torch, plain, prompts, MAX_TOKENS)["finals"]]
    same = got == want
    ties = worst = None
    if not same:
        ties, worst = argmax_gaps(torch, prefill_fn, plain.runner._compute,
                                  plain.model_cfg, prompts, got)
        if not worst <= LOGITS_TOL["max_abs"]:
            fail(f"serve_mesh: after update_weights the streams differ "
                 f"from a plain engine's on the same params and a "
                 f"committed token's logit is {worst} below its row's max "
                 f"(tol {LOGITS_TOL['max_abs']})")
    del plain
    release(torch)
    return {"swap_s": swap_s, "noise": "0.01 normal, seed 9",
            "registrations_dropped": swap["registrations_dropped"],
            "streams_changed": True,
            "streams_identical_to_plain_on_new_params": same,
            "tokens_not_argmax": ties, "max_gap_to_argmax": worst,
            "tokens_per_s": again["tokens_per_s"], "launches": relaunch}


def phase_ulysses(torch) -> dict:
    """Ulysses on a one-rank NCCL ``seq`` mesh at ULYSSES_SHAPE in bf16,
    forward and backward through ``ops.attention.causal_attention`` (K1,
    then K2 and K3), against one direct ``flash_attention`` call on the
    same q, k, v and output gradient: 1/1/1 launches a call, and the
    outputs and gradients compared (bit-equal expected, within BWD_TOL
    required). Then ring attention at the same shape in f32 against the
    plain reference, within RING_TOL; each timed. Returns the launches
    of one Ulysses forward and backward."""
    from ray_tpu_torch.ops.attention import (
        causal_attention,
        causal_attention_reference,
    )
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel.mesh import build_mesh
    from ray_tpu_torch.parallel.ops import shard_map
    from ray_tpu_torch.parallel.ring_attention import (
        ring_attention,
        ulysses_attention,
    )
    from ray_tpu_torch.parallel.sharding import PartitionSpec as P

    B, T, H, D = ULYSSES_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))

    def fwd_bwd(fn, dtype=torch.bfloat16):
        qkv = [t.to(dtype).detach().requires_grad_(True) for t in (q, k, v)]
        o = fn(*qkv)
        o = o.to_local() if hasattr(o, "to_local") else o
        grads = torch.autograd.grad(o, qkv, grad_outputs=do.to(dtype))
        return [o.detach()] + list(grads)

    with one_rank_nccl():
        mesh = build_mesh({"seq": 1})
        spec = P(None, "seq")
        uly = shard_map(lambda a, b, c: ulysses_attention(
            a, b, c, "seq", attn_fn=causal_attention), mesh,
            in_specs=spec, out_specs=spec)
        ring = shard_map(lambda a, b, c: ring_attention(a, b, c, "seq"),
                         mesh, in_specs=spec, out_specs=spec)
        counters = _reset_counters()
        got = fwd_bwd(uly)
        launches = launch_counts(counters)
        direct = fwd_bwd(lambda a, b, c: flash_attention(a, b, c,
                                                         causal=True))
        want = {"flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1,
                "paged_attention": 0}
        if {k_: launches[k_] for k_ in want} != want:
            fail(f"ulysses: launches {launches}, want {want}")
        diffs = {n: float((a.float() - b.float()).abs().max())
                 for n, a, b in zip(("o", "dq", "dk", "dv"), got, direct)}
        bit_equal = all(torch.equal(a, b) for a, b in zip(got, direct))
        tol = BWD_TOL["bfloat16"]
        for n, a, b in zip(("o", "dq", "dk", "dv"), got, direct):
            if not torch.allclose(a.float(), b.float(), **tol):
                fail(f"ulysses: {n} against a direct flash_attention call: "
                     f"max abs {diffs[n]} ({tol})")
        uly_ms = events_ms(torch, lambda: fwd_bwd(uly))
        direct_ms = events_ms(torch, lambda: fwd_bwd(
            lambda a, b, c: flash_attention(a, b, c, causal=True)))
        uly_fwd_ms = events_ms(torch, lambda: uly(q, k, v))
        qf, kf, vf = (t.float() for t in (q, k, v))
        with torch.no_grad():
            ring_out = ring(qf, kf, vf).to_local()
            ref = causal_attention_reference(qf, kf, vf)
            ring_err = float((ring_out - ref).abs().max())
            if not torch.allclose(ring_out, ref, **RING_TOL):
                fail(f"ring: against the plain reference, max abs "
                     f"{ring_err} ({RING_TOL})")
            ring_ms = events_ms(torch, lambda: ring(qf, kf, vf))
            ref_ms = events_ms(torch, lambda: causal_attention_reference(
                qf, kf, vf))
        del ring_out, ref
    emit({"phase": "ulysses", "world": 1, "backend": "nccl",
          "mesh": {"seq": 1}, "shape": list(ULYSSES_SHAPE),
          "dtype": "bfloat16", "attn_fn": "ops.attention.causal_attention",
          "launches": launches, "bit_equal_to_direct_flash": bit_equal,
          "max_abs_diff_to_direct": diffs, "tol": tol,
          "ulysses_fwd_bwd_ms": uly_ms, "direct_flash_fwd_bwd_ms": direct_ms,
          "ulysses_fwd_ms": uly_fwd_ms,
          "ring": {"dtype": "float32", "max_abs_err": ring_err,
                   "tol": RING_TOL, "fwd_ms": ring_ms,
                   "plain_reference_fwd_ms": ref_ms}})
    release(torch)
    return launches


def phase_moe(torch) -> None:
    """The MoE layer (``models.moe``) at MOE_CFG in bf16 on a one-rank
    NCCL ``expert`` mesh, the experts laid out by its partition rules, on
    x of MOE_X: forward and forward + backward timed, peak memory; then
    MOE_CHECK_BATCH sequences through it on the card against the same
    function in f32 on the CPU (MOE_TOL over the tokens routed alike,
    at most MOE_MAX_REROUTED routed otherwise), and the aux loss."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from ray_tpu_torch.models.moe import (
        MoEConfig,
        init_moe,
        moe_layer,
        moe_partition_rules,
    )
    from ray_tpu_torch.parallel.mesh import build_mesh
    from ray_tpu_torch.parallel.sharding import PartitionRules, shard_pytree
    from ray_tpu_torch.util import tree

    cfg = MoEConfig(**MOE_CFG, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    params = init_moe(gen, cfg)
    x = torch.randn(*MOE_X, generator=gen, device="cuda").to(torch.bfloat16)

    def route(xx, gate):
        probs = torch.softmax(xx.reshape(-1, cfg.d_model).float()
                              @ gate.float(), dim=-1)
        return torch.topk(probs, cfg.top_k, dim=-1).indices.sort(-1).values

    with one_rank_nccl():
        mesh = build_mesh({"expert": 1})
        p = shard_pytree({"moe": params}, PartitionRules(
            moe_partition_rules()), mesh)["moe"]
        xd = distribute_tensor(x, mesh, [Replicate()])

        def forward():
            with torch.no_grad():
                return moe_layer(p, xd, cfg)

        def fwd_bwd():
            leaves = [t.detach().requires_grad_(True)
                      for t in tree.leaves(p)]
            pp = tree.unflatten(p, leaves)
            out, aux = moe_layer(pp, xd, cfg)
            loss = (out.float() ** 2).mean() + 0.01 * aux
            return torch.autograd.grad(loss, leaves)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        grads = fwd_bwd()
        peak = torch.cuda.max_memory_allocated()
        gnorm = float(sum(float((g.full_tensor() if isinstance(g, DTensor)
                                 else g).float().norm()) ** 2
                          for g in grads) ** 0.5)
        fwd_ms = events_ms(torch, forward)
        step_ms = events_ms(torch, fwd_bwd)
        xs = x[:MOE_CHECK_BATCH]
        with torch.no_grad():
            out, aux = moe_layer(p, distribute_tensor(xs, mesh,
                                                      [Replicate()]), cfg)
            out, aux = out.full_tensor(), float(aux.full_tensor())
        del grads
    host = {"gate": {"kernel": params["gate"]["kernel"].cpu()},
            "wi": params["wi"].cpu(), "wo": params["wo"].cpu()}
    cpu_cfg = MoEConfig(**MOE_CFG, dtype=torch.float32)
    with torch.no_grad():
        want, want_aux = moe_layer(host, xs.float().cpu(), cpu_cfg)
    same = (route(xs, params["gate"]["kernel"]).cpu()
            == route(xs.float().cpu(), host["gate"]["kernel"])).all(-1)
    rerouted = int((~same).sum())
    got = out.float().cpu().reshape(-1, cfg.d_model)[same]
    ref = want.reshape(-1, cfg.d_model)[same]
    err = float((got - ref).abs().max())
    ok = torch.allclose(got, ref, **MOE_TOL)
    N = MOE_X[0] * MOE_X[1]
    cap = max(1, int(cfg.capacity_factor * N * cfg.top_k
                     / cfg.num_experts))
    row = {"phase": "moe", "world": 1, "backend": "nccl",
           "mesh": {"expert": 1}, "config": MOE_CFG, "dtype": "bfloat16",
           "x": list(MOE_X), "capacity": cap,
           "combine_bytes": N * cfg.num_experts * cap * 4,
           "fwd_ms": fwd_ms, "fwd_bwd_ms": step_ms,
           "max_memory_allocated": peak, "grad_norm": gnorm,
           "check": {"sequences": MOE_CHECK_BATCH, "rerouted_tokens":
                     rerouted, "max_rerouted": MOE_MAX_REROUTED,
                     "max_abs_err": err, "tol": MOE_TOL, "aux": aux,
                     "aux_cpu_f32": float(want_aux)}}
    emit(row)
    if not (ok and rerouted <= MOE_MAX_REROUTED
            and math.isfinite(gnorm) and gnorm > 0
            and abs(aux - float(want_aux)) <= 1e-3 * abs(float(want_aux))):
        fail(f"moe: against the CPU's f32 layer: {row['check']}, grad "
             f"norm {gnorm}")
    release(torch)


def phase_pipelined(torch, keep: dict | None = None) -> None:
    """The pipelined transformer (``models.pipelined``) at PIPELINED_CFG
    on a one-rank NCCL (pipe=1, fsdp=1) mesh, params laid out by
    `pipelined_shardings`: the chain of `stage_apply` over
    PIPELINED_CHAIN_STAGES stages (no mesh) against the first step's
    `pipelined_loss`, then two `pipelined_train_step`s; the loss must
    fall. Step ms and peak memory. `keep`, if given, takes the batch
    (host tokens), the losses and the step ms (phase 16 holds its runs
    against them)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from ray_tpu_torch.models.pipelined import (
        PipelinedConfig,
        init_pipelined,
        pipelined_shardings,
        pipelined_train_step,
        split_pipeline_stages,
        stage_apply,
    )
    from ray_tpu_torch.parallel.mesh import build_mesh
    from ray_tpu_torch.util import tree

    cfg = PipelinedConfig(**PIPELINED_CFG)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    params = init_pipelined(gen, cfg)
    n_params = sum(t.numel() for t in tree.leaves(params))
    toks = torch.randint(0, cfg.vocab_size,
                         (PIPELINED_BATCH, cfg.block_size + 1),
                         generator=gen, device="cuda")
    S = PIPELINED_CHAIN_STAGES
    with torch.no_grad():
        h = toks[:, :-1]
        for s, stage in enumerate(split_pipeline_stages(params, cfg, S)):
            h = stage_apply(cfg, stage, s, S, h,
                            toks[:, 1:] if s == S - 1 else None)
        chain = float(h)
    del h
    with one_rank_nccl():
        mesh = build_mesh({"pipe": 1, "fsdp": 1})
        shard = pipelined_shardings(params, cfg, mesh)
        p = tree.unflatten(params, [
            distribute_tensor(t, mesh, sh.placements)
            for t, sh in zip(tree.leaves(params), tree.leaves(shard))])
        del params
        batch = {k: distribute_tensor(t, mesh, [Replicate()]) for k, t in
                 (("tokens", toks[:, :-1]), ("targets", toks[:, 1:]))}
        step = pipelined_train_step(cfg, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            p, loss = step(p, batch)
            losses.append(float(loss.full_tensor()))
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        del p, batch
    # at pipe=1 every block is a repeat of the one stage: R*M + S - 1
    ticks = cfg.n_virtual_stages * cfg.num_microbatches
    row = {"phase": "pipelined", "world": 1, "backend": "nccl",
           "mesh": {"pipe": 1, "fsdp": 1}, "config": PIPELINED_CFG,
           "batch": PIPELINED_BATCH, "dtype": "float32",
           "params": n_params, "schedule_ticks": ticks,
           "optimizer": "sgd(1e-2)", "losses": losses, "step_ms": ms,
           "max_memory_allocated": peak,
           "stage_chain": {"stages": S, "loss": chain,
                           "rel_diff": abs(chain - losses[0])
                           / abs(losses[0]), "rtol": PIPELINED_RTOL}}
    emit(row)
    if not (all(map(math.isfinite, losses)) and losses[1] < losses[0]):
        fail(f"pipelined: losses {losses} do not fall")
    if not row["stage_chain"]["rel_diff"] <= PIPELINED_RTOL:
        fail(f"pipelined: the stage chain's loss {chain} against "
             f"pipelined_loss's {losses[0]} (rtol {PIPELINED_RTOL})")
    if keep is not None:
        keep.update(tokens=toks.cpu().numpy(), losses=losses, step_ms=ms)
    release(torch)


# ------------------------------------------------------------ phase 10


def on_cuda(what: str, *trees) -> None:
    """Fail unless every tensor leaf of `trees` lies on the card."""
    from ray_tpu_torch.util import tree

    off = {str(t.device) for tr in trees for t in tree.leaves(tr)
           if t.device.type != "cuda"}
    if off:
        fail(f"{what}: param tensors on {sorted(off)}, not on cuda")


def spread(xs) -> dict:
    """Median and max of a list of numbers."""
    return {"median": float(np.median(xs)), "max": float(np.max(xs))}


def profiled_call(torch, fn) -> dict:
    """One call of `fn` under torch.profiler (CUDA activity only): the
    device's busy time and share of the call's wall time, and its time
    by kernel class."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out = device_time(torch, prof, wall_us)
    del out["top_kernels_ms"]
    return out


def _ppo_rows(results: list[dict]) -> dict:
    return {k: spread([r[k] for r in results])
            for k in ("env_steps_per_sec", "time_sample_s", "time_learn_s")}


def phase_ppo_cartpole(torch, card: str) -> dict:
    """PPO on CartPole-v1 through ``PPOConfig(...).build().train()`` on
    the card (the JAX package's inline recipe): the best
    episode_return_mean must reach PPO_TARGET within PPO_ITERS
    iterations. Then one profiled iteration and PPO_PIPELINED_ITERS
    iterations of a second run with pipeline_sampling. Returns the first
    run's env_steps_per_sec (median, max)."""
    from ray_tpu_torch.rllib import PPOConfig

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(**PPO_CARTPOLE)
            .training(**PPO_CARTPOLE_TRAINING)).build()
    on_cuda("ppo_cartpole", algo.learner.params,
            algo.env_runner_group.local.params)
    results, best, iters = [], float("-inf"), 0
    t0 = time.perf_counter()
    for iters in range(1, PPO_ITERS + 1):
        r = algo.train()
        results.append(r)
        if r["episode_return_mean"] == r["episode_return_mean"]:
            best = max(best, r["episode_return_mean"])
        if best >= PPO_TARGET:
            break
    train_s = time.perf_counter() - t0
    profile = profiled_call(torch, algo.train)
    peak = torch.cuda.max_memory_allocated()
    algo.stop()
    del algo

    piped = (PPOConfig().environment("CartPole-v1")
             .env_runners(**PPO_CARTPOLE)
             .training(pipeline_sampling=True,
                       **PPO_CARTPOLE_TRAINING)).build()
    on_cuda("ppo_cartpole pipelined", piped.learner.params,
            piped.env_runner_group.local.params)
    pipelined = [piped.train() for _ in range(PPO_PIPELINED_ITERS)]
    piped.stop()
    del piped
    emit({"phase": "ppo_cartpole", "card": card, "iterations": iters,
          "best_episode_return_mean": best, "target": PPO_TARGET,
          "train_s": train_s, **_ppo_rows(results),
          "profiled_iteration": profile, "max_memory_allocated": peak,
          "memory_allocated_at_start": base,
          "pipelined": {
              "iterations": PPO_PIPELINED_ITERS,
              "time_sample_s": [r["time_sample_s"] for r in pipelined],
              "time_learn_s": [r["time_learn_s"] for r in pipelined],
              "env_steps_per_sec": [r["env_steps_per_sec"]
                                    for r in pipelined]}})
    if best < PPO_TARGET:
        fail(f"ppo_cartpole: best episode_return_mean {best} after "
             f"{iters} iterations, below {PPO_TARGET}")
    release(torch)
    return _ppo_rows(results)["env_steps_per_sec"]


def phase_ppo_pixel(torch, card: str) -> None:
    """PPO with the conv catalog and the frame-stack connector on
    PixelCatch-v0 (the JAX package's conv recipe without its 4-device
    mesh), PPO_PIXEL_ITERS iterations: the last episode_return_mean must
    exceed 2 and the first by 2, and the metrics tree must hold the
    learner's and the env runners' metrics."""
    from ray_tpu_torch.rllib import PPOConfig

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    algo = (PPOConfig().environment("PixelCatch-v0")
            .env_runners(**PPO_PIXEL)
            .training(**PPO_PIXEL_TRAINING)).build()
    on_cuda("ppo_pixel", algo.learner.params,
            algo.env_runner_group.local.params)
    results, first, last = [], None, None
    t0 = time.perf_counter()
    for _ in range(PPO_PIXEL_ITERS):
        r = algo.train()
        results.append(r)
        if not np.isnan(r["episode_return_mean"]):
            if first is None:
                first = r["episode_return_mean"]
            last = r["episode_return_mean"]
    train_s = time.perf_counter() - t0
    tree_keys = sorted(algo.metrics.reduce())
    peak = torch.cuda.max_memory_allocated()
    algo.stop()
    emit({"phase": "ppo_pixel", "card": card, "iterations": PPO_PIXEL_ITERS,
          "first_episode_return_mean": first,
          "last_episode_return_mean": last, "train_s": train_s,
          **_ppo_rows(results), "metrics_tree": tree_keys,
          "max_memory_allocated": peak, "memory_allocated_at_start": base})
    if first is None or last is None or not (last > 2.0 and
                                             last > first + 2.0):
        fail(f"ppo_pixel: conv PPO failed to learn: first={first} "
             f"last={last}")
    if not {"learner", "env_runners"} <= set(tree_keys):
        fail(f"ppo_pixel: the metrics tree holds {tree_keys}")
    release(torch)


def atari_flops_per_sample() -> float:
    """Forward FLOPs of one observation through the catalog's Atari
    encoder (ATARI_FILTERS, "SAME" padding, a 256-wide projection) and
    its two heads: 2 x multiply-adds."""
    from ray_tpu_torch.rllib.catalog import ATARI_FILTERS

    h, w, c = ATARI_OBS
    flops = 0.0
    for oc, k, s in ATARI_FILTERS:
        h, w = -(-h // s), -(-w // s)
        flops += 2.0 * h * w * oc * k * k * c
        c = oc
    flat = h * w * c
    return flops + 2.0 * flat * 256 + 2.0 * 256 * (ATARI_ACTIONS + 1)


def atari_batch(n: int) -> dict:
    rng = np.random.RandomState(7)
    return {
        "obs": rng.rand(n, *ATARI_OBS).astype(np.float32),
        "actions": rng.randint(0, ATARI_ACTIONS, n),
        "logp_old": (rng.randn(n) * 0.1 - np.log(ATARI_ACTIONS))
        .astype(np.float32),
        "advantages": rng.randn(n).astype(np.float32),
        "value_targets": rng.randn(n).astype(np.float32),
    }


def phase_ppo_learner_atari(torch, card: str) -> None:
    """``PPOLearner(ATARI_OBS, ATARI_ACTIONS)`` at the catalog's full
    width on the card: one `update` of ATARI_BATCH seeded transitions
    (num_sgd_iter 1, minibatches of ATARI_MINIBATCH), each SGD step
    timed by CUDA events; a second update under torch.profiler for the
    busy share; the bound of one SGD step (3 x forward FLOPs); then one
    f32 SGD step on the card against the same step on the CPU."""
    from ray_tpu_torch.rllib.learner import PPOLearner, PPOLearnerConfig
    from ray_tpu_torch.util import tree

    cfg = PPOLearnerConfig(num_sgd_iter=1, minibatch_size=ATARI_MINIBATCH)
    learner = PPOLearner(ATARI_OBS, ATARI_ACTIONS, cfg)
    on_cuda("ppo_learner_atari", learner.params)
    w0 = learner.get_weights()
    batch = atari_batch(ATARI_BATCH)
    n_params = sum(t.numel() for t in tree.leaves(learner.params))

    step_ms = []
    plain_step = learner.sgd_step

    def timed_step(mb):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = plain_step(mb)
        end.record()
        step_ms.append((start, end))
        return out

    learner.update(batch)  # warm-up: cuDNN picks its algorithms
    learner.sgd_step = timed_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    metrics = learner.update(batch)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ms = [a.elapsed_time(b) for a, b in step_ms]
    learner.sgd_step = plain_step
    busy = profiled_call(torch, lambda: learner.update(batch))
    del learner
    release(torch)

    flops = 3.0 * atari_flops_per_sample() * ATARI_MINIBATCH
    nbytes = 4.0 * (ATARI_MINIBATCH * (int(np.prod(ATARI_OBS)) + 4)
                    + 2 * n_params)
    bound_bf16, by_bf16 = bound(flops, nbytes, "bfloat16")
    bound_f32, by_f32 = bound(flops, nbytes, "float32")

    # parity: one f32 SGD step from w0 on the card and on the CPU
    card_l = PPOLearner(ATARI_OBS, ATARI_ACTIONS, cfg)
    cpu_l = PPOLearner(ATARI_OBS, ATARI_ACTIONS, cfg, device="cpu")
    card_l.set_weights(w0)
    cpu_l.set_weights(w0)
    mb = {k: torch.from_numpy(v[:ATARI_MINIBATCH])
          for k, v in batch.items()}
    loss_card = float(card_l.sgd_step(
        {k: v.to("cuda") for k, v in mb.items()})["total_loss"])
    loss_cpu = float(cpu_l.sgd_step(mb)["total_loss"])
    worst = 0.0
    for a, b in zip(tree.leaves(card_l.get_weights()),
                    tree.leaves(cpu_l.get_weights())):
        worst = max(worst, float(np.abs(a - b).max()
                                 / max(np.abs(b).max(), 1e-30)))
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    del card_l, cpu_l
    emit({"phase": "ppo_learner_atari", "card": card, "obs": ATARI_OBS,
          "actions": ATARI_ACTIONS, "params": n_params,
          "batch": ATARI_BATCH, "minibatch": ATARI_MINIBATCH,
          "sgd_steps": len(ms), "sgd_step_ms": spread(ms),
          "samples_per_sec": ATARI_BATCH / update_s,
          "update_s": update_s, "metrics": metrics,
          "profiled_update": busy,
          "max_memory_allocated": peak, "memory_allocated_at_start": base,
          "sgd_step_flops": flops,
          "bound_ms_at_bf16_peak": bound_bf16, "bound_by_bf16": by_bf16,
          "bound_ms_at_f32_peak": bound_f32, "bound_by_f32": by_f32,
          "parity": {"loss_card": loss_card, "loss_cpu": loss_cpu,
                     "loss_rel": loss_rel, "param_rel_of_leaf_max": worst,
                     "tol": ATARI_PARITY}})
    if len(ms) != ATARI_BATCH // ATARI_MINIBATCH:
        fail(f"ppo_learner_atari: {len(ms)} SGD steps, expected "
             f"{ATARI_BATCH // ATARI_MINIBATCH}")
    if not (loss_rel <= ATARI_PARITY["loss_rel"]
            and worst <= ATARI_PARITY["param"]):
        fail(f"ppo_learner_atari: card against CPU: loss rel {loss_rel}, "
             f"params {worst} of the leaf's largest ({ATARI_PARITY})")
    release(torch)


def phase_dqn_cartpole(torch, card: str) -> None:
    """DQN with prioritized replay on CartPole-v1 through
    ``DQNConfig(prioritized_replay=True)...build().train()`` on the
    card, DQN_ITERS iterations: every td_loss reported after learning
    starts finite, the buffer growing, one target sync every
    target_update_freq updates (seen as a new target tree between
    iterations), epsilon decaying. No learning threshold."""
    from ray_tpu_torch.rllib import DQNConfig

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    algo = (DQNConfig(prioritized_replay=True).environment("CartPole-v1")
            .env_runners(**DQN_RUNNERS).training(**DQN_TRAINING)).build()
    on_cuda("dqn_cartpole", algo.params, algo.target_params,
            algo.env_runner_group.local.params)
    rows, syncs, update_s = [], 0, 0.0
    target = algo.target_params
    for _ in range(DQN_ITERS):
        before = algo._updates
        t0 = time.perf_counter()
        r = algo.train()
        dt = time.perf_counter() - t0
        if algo._updates > before:
            update_s += dt
        if algo.target_params is not target:
            syncs += 1
            target = algo.target_params
        rows.append({"return": r["episode_return_mean"],
                     "td_loss": r["learner/td_loss"],
                     "epsilon": r["epsilon"],
                     "buffer_size": r["buffer_size"],
                     "updates": algo._updates - before})
    updates = algo._updates
    peak = torch.cuda.max_memory_allocated()
    freq = algo.config.target_update_freq
    algo.stop()
    returns = [x["return"] for x in rows if x["return"] == x["return"]]
    emit({"phase": "dqn_cartpole", "card": card, "iterations": DQN_ITERS,
          "first_episode_return_mean": returns[0] if returns else None,
          "last_episode_return_mean": returns[-1] if returns else None,
          "updates": updates, "updates_per_sec": updates / update_s
          if update_s else None, "target_syncs": syncs,
          "target_update_freq": freq, "max_memory_allocated": peak,
          "memory_allocated_at_start": base,
          "iterations_detail": rows})
    learning = [x for x in rows if x["updates"]]
    if not learning or not all(math.isfinite(x["td_loss"])
                               for x in learning):
        fail(f"dqn_cartpole: td_loss not finite once learning started: "
             f"{[x['td_loss'] for x in rows]}")
    sizes = [x["buffer_size"] for x in rows]
    if any(b <= a for a, b in zip(sizes, sizes[1:])):
        fail(f"dqn_cartpole: the buffer does not grow: {sizes}")
    if syncs != updates // freq:
        fail(f"dqn_cartpole: {syncs} target syncs after {updates} "
             f"updates at one every {freq}")
    eps = [x["epsilon"] for x in rows]
    if any(b >= a for a, b in zip(eps, eps[1:])):
        fail(f"dqn_cartpole: epsilon does not decay: {eps}")
    release(torch)


def phase_ppo_learners() -> None:
    """``PPOConfig().learners(num_learners=1)`` builds at world 1 (no
    mesh); on a one-rank process group ``learners(num_learners=2)`` must
    refuse to build, naming both sizes."""
    from ray_tpu_torch.rllib import PPOConfig

    def config(n):
        return (PPOConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=0).learners(num_learners=n))

    algo = config(1).build()
    if algo.learner.mesh is not None:
        fail("ppo_learners: num_learners=1 built a mesh")
    algo.stop()
    with one_rank_nccl():
        try:
            config(2).build()
        except ValueError as e:
            msg = str(e)
        else:
            fail("ppo_learners: num_learners=2 on one rank built")
    if "2" not in msg or "1" not in msg:
        fail(f"ppo_learners: the refusal does not name both sizes: {msg}")
    emit({"phase": "ppo_learners", "num_learners_1": "built, no mesh",
          "num_learners_2_on_one_rank": msg})


# ------------------------------------------------------------ phase 11


def _timed(torch, algo, name: str = "_update") -> list:
    """Wrap `algo`'s method `name` (the learner's step) so that each
    call is bracketed by CUDA events; returns the list the (start, end)
    pairs are appended to (read them after a synchronize)."""
    plain = getattr(algo, name)
    pairs: list = []

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = plain(*args, **kw)
        end.record()
        pairs.append((start, end))
        return out

    setattr(algo, name, timed)
    return pairs


def _event_ms(torch, pairs) -> dict | None:
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in pairs]
    return spread(ms) if ms else None


def _pixel_run(torch, iters: int) -> tuple[list, dict, list]:
    """`ppo_pixel`'s recipe for `iters` iterations from its seeds: the
    returns, the learner's host params and each iteration's seconds."""
    from ray_tpu_torch.rllib import PPOConfig

    algo = (PPOConfig().environment("PixelCatch-v0")
            .env_runners(**PPO_PIXEL)
            .training(**PPO_PIXEL_TRAINING)).build()
    on_cuda("f3_determinism", algo.learner.params,
            algo.env_runner_group.local.params)
    returns, secs = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        returns.append(algo.train()["episode_return_mean"])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    weights = algo.learner.get_weights()
    algo.stop()
    return returns, weights, secs


def _same(a: tuple, b: tuple) -> dict:
    """Bitwise comparison of two `_pixel_run`s: returns and each param
    leaf (by path)."""
    from ray_tpu_torch.util import tree

    same_returns = np.array_equal(np.asarray(a[0]), np.asarray(b[0]),
                                  equal_nan=True)
    leaves = {"/".join(p): bool(np.array_equal(x, y)) for (p, x), (_, y) in
              zip(tree.leaves_with_path(a[1]), tree.leaves_with_path(b[1]))}
    return {"returns_equal": bool(same_returns),
            "params_equal": all(leaves.values()),
            "leaves_differing": sorted(p for p, s in leaves.items()
                                       if not s)}


def phase_f3_determinism(torch, card: str) -> None:
    """F3: `ppo_pixel`'s recipe for F3_ITERS iterations, four times from
    the same seeds: with the learner's updates under cuDNN's
    deterministic algorithms (``catalog.deterministic_convs``, as the
    port runs them), then twice with the context made a no-op, then
    with it again. The two runs with it must be bitwise equal, returns
    and params; what the runs without it change is reported, not
    required. The order (with, without, without, with) spreads warm-up
    over both sides: the flag's cost is the difference of each adjacent
    pair's median iteration seconds (first iterations dropped)."""
    from ray_tpu_torch.rllib import catalog

    real = catalog.deterministic_convs

    def run(flag: bool) -> tuple:
        catalog.deterministic_convs = real if flag else \
            contextlib.nullcontext
        try:
            return _pixel_run(torch, F3_ITERS)
        finally:
            catalog.deterministic_convs = real

    runs = [run(flag) for flag in (True, False, False, True)]
    on, off = (runs[0], runs[3]), (runs[1], runs[2])
    with_flag, without = _same(*on), _same(*off)
    med = [float(np.median(r[2][1:])) for r in runs]
    paired = [med[0] - med[1], med[3] - med[2]]
    emit({"phase": "f3_determinism", "card": card, "iterations": F3_ITERS,
          "kernels_launched": "none of K1-K4 (conv PPO)",
          "with_deterministic_cudnn": with_flag,
          "without": without,
          "returns": [x if x == x else None for x in on[0][0]],
          "order": ["with", "without", "without", "with"],
          "median_iteration_s": med,
          "paired_cost_s": paired,
          "cost_s": float(np.mean(paired)),
          "cost_rel": float(np.mean(paired)) / float(np.mean(med[1:3])),
          "iteration_s_with_flag": spread(on[0][2][1:] + on[1][2][1:]),
          "iteration_s_without": spread(off[0][2][1:] + off[1][2][1:])})
    if not (with_flag["returns_equal"] and with_flag["params_equal"]):
        fail(f"f3_determinism: two seeded ppo_pixel runs differ under "
             f"deterministic cuDNN: {with_flag}")
    release(torch)


def _learn_to(torch, card: str, phase: str, algo, target: float,
              strict: bool, limit_s: float, params) -> dict:
    """Train an IMPALA-family `algo` until its best return reaches
    `target` (above it when `strict`) or `limit_s` seconds pass; one
    profiled iteration; the learner's step timed by CUDA events in the
    run and then alone (`_update_alone`, which stops the thread)."""
    on_cuda(phase, params, algo.env_runner_group.local.params)
    pairs = _timed(torch, algo)
    best, iters, rows = float("-inf"), 0, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < limit_s:
        r = algo.train()
        iters += 1
        rows.append(r)
        if r["episode_return_mean"] == r["episode_return_mean"]:
            best = max(best, r["episode_return_mean"])
        if best > target or (not strict and best >= target):
            break
    train_s = time.perf_counter() - t0
    updates = algo.learner_thread.num_updates
    interval_ms = _event_ms(torch, pairs[:])
    profile = profiled_call(torch, algo.train)
    alone_ms = _update_alone(torch, algo)
    return {"phase": phase, "card": card,
            "kernels_launched": "none of K1-K4 (MLP towers)",
            "iterations": iters, "train_s": train_s,
            "best_episode_return_mean": best, "target": target,
            "limit_s": limit_s,
            "env_steps_per_sec": spread([x["env_steps_per_sec"]
                                         for x in rows]),
            "learner_updates": updates,
            "learner_updates_per_sec": updates / train_s,
            "learner_queue_size": spread([x["learner_queue_size"]
                                          for x in rows]),
            "update_interval_ms": interval_ms, "update_ms": alone_ms,
            "update_alone_n": UPDATE_ALONE, "profiled_iteration": profile,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def _update_alone(torch, algo) -> dict:
    """The learner's step alone on the card: the learner thread
    stopped, UPDATE_ALONE fresh fragments' batches each stepped on this
    thread between two CUDA events, after a synchronize, so no driver
    work lies between the events (in the run the driver enqueues its
    forwards on the same stream meanwhile). APPO's step keeps its
    target-copy count."""
    algo.learner_thread.stopped.set()
    algo.learner_thread.join()
    step = type(algo)._update
    pairs = []
    for _ in range(UPDATE_ALONE):
        batch = algo._to_batch(algo.env_runner_group.local.sample())
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(algo, batch)
        end.record()
        pairs.append((start, end))
    return _event_ms(torch, pairs)


def phase_impala_cartpole(torch, card: str) -> None:
    """IMPALA on CartPole-v1 through ``IMPALAConfig()...build().train()``
    (the JAX package's inline recipe: 16 envs x 64 steps, the learner
    thread): the best return must reach IMPALA_TARGET within
    IMPALA_LIMIT_S seconds, with more than 50 learner updates."""
    from ray_tpu_torch.rllib import IMPALAConfig

    torch.cuda.reset_peak_memory_stats()
    algo = (IMPALAConfig().environment("CartPole-v1")
            .env_runners(**IMPALA_CARTPOLE)).build()
    row = _learn_to(torch, card, "impala_cartpole", algo, IMPALA_TARGET,
                    False, IMPALA_LIMIT_S, algo.params)
    algo.stop()
    emit(row)
    if row["best_episode_return_mean"] < IMPALA_TARGET:
        fail(f"impala_cartpole: best {row['best_episode_return_mean']} "
             f"after {row['train_s']:.1f} s, below {IMPALA_TARGET}")
    if row["learner_updates"] <= 50:
        fail(f"impala_cartpole: {row['learner_updates']} learner updates")
    release(torch)


def phase_appo_cartpole(torch, card: str) -> None:
    """APPO on CartPole-v1 (lr 1e-3, the KL term to the target network):
    the best return must exceed APPO_TARGET within APPO_LIMIT_S
    seconds; the target is copied once every target_update_freq
    learner steps."""
    from ray_tpu_torch.rllib import APPOConfig

    torch.cuda.reset_peak_memory_stats()
    algo = (APPOConfig().environment("CartPole-v1")
            .env_runners(**IMPALA_CARTPOLE)
            .training(**APPO_TRAINING)).build()
    on_cuda("appo_cartpole", algo.target_params)
    row = _learn_to(torch, card, "appo_cartpole", algo, APPO_TARGET, True,
                    APPO_LIMIT_S, algo.params)
    algo.stop()  # joins the learner thread: the counts below are final
    freq = algo.config.target_update_freq
    row.update(appo_updates=algo._appo_updates,
               target_syncs=algo._target_syncs, target_update_freq=freq)
    emit(row)
    if not row["best_episode_return_mean"] > APPO_TARGET:
        fail(f"appo_cartpole: best {row['best_episode_return_mean']} "
             f"after {row['train_s']:.1f} s, not above {APPO_TARGET}")
    if algo._appo_updates <= 0 or \
            algo._target_syncs != algo._appo_updates // freq:
        fail(f"appo_cartpole: {algo._target_syncs} target syncs after "
             f"{algo._appo_updates} updates at one every {freq}")
    release(torch)


def phase_sac_pendulum(torch, card: str) -> None:
    """SAC on the port's Pendulum-v1 (the JAX package's recipe: seed 1,
    4 envs x 16 steps, 48 updates an iteration from 1,000 steps on):
    the mean of the last 20 returns from iteration SAC_LATE on must
    exceed the mean of the first 20 by SAC_GAIN within SAC_ITERS
    iterations, and the temperature must fall into (0, 1)."""
    from ray_tpu_torch.rllib import SACConfig

    torch.cuda.reset_peak_memory_stats()
    algo = SACConfig().training(**SAC_TRAINING).build()
    on_cuda("sac_pendulum", algo.params, algo.target_q, algo.log_alpha)
    pairs = _timed(torch, algo)
    early, late, met, iters = [], [], False, 0
    t0 = time.perf_counter()
    for i in range(SAC_ITERS):
        r = algo.train()
        iters = i + 1
        if r["episode_return_mean"] == r["episode_return_mean"]:
            (early if i < SAC_LATE else late).append(
                r["episode_return_mean"])
        met = (len(early) >= 20 and len(late) >= 20 and
               np.mean(late[-20:]) > np.mean(early[:20]) + SAC_GAIN
               and 0 < r["alpha"] < 1)
        if met:
            break
    train_s = time.perf_counter() - t0
    updates, update_ms = len(pairs), _event_ms(torch, pairs[:])
    profile = profiled_call(torch, algo.train)
    algo.stop()
    emit({"phase": "sac_pendulum", "card": card,
          "kernels_launched": "none of K1-K4 (MLPs)", "iterations": iters,
          "train_s": train_s,
          "early_mean": float(np.mean(early[:20])) if early else None,
          "late_mean": float(np.mean(late[-20:])) if late else None,
          "gain": SAC_GAIN, "alpha": r["alpha"],
          "updates": updates, "updates_per_sec": updates / train_s,
          "update_ms": update_ms, "profiled_iteration": profile,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    if not met:
        fail(f"sac_pendulum: after {iters} iterations the late mean "
             f"{np.mean(late[-20:]) if late else None} is not the early "
             f"{np.mean(early[:20]) if early else None} + {SAC_GAIN}, or "
             f"alpha {r['alpha']} is outside (0, 1)")
    release(torch)


def _dreamer(torch, card: str, phase: str, env: str, training: dict,
             pixels: bool) -> None:
    """DreamerV3 through ``DreamerV3Config()...build().train()``: the
    world model's total loss must fall below 0.8 of its first within
    DREAMER_ITERS iterations, every metric of the last finite."""
    from ray_tpu_torch.rllib import DreamerV3Config

    torch.cuda.reset_peak_memory_stats()
    algo = DreamerV3Config().environment(env).training(**training).build()
    on_cuda(phase, algo.wm, algo.actor, algo.critic, algo.critic_ema)
    pairs = _timed(torch, algo)
    first = last = None
    iters = 0
    t0 = time.perf_counter()
    for iters in range(1, DREAMER_ITERS + 1):
        r = algo.train()
        if "wm/total" in r:
            first = r["wm/total"] if first is None else first
            last = r["wm/total"]
        if first is not None and last < 0.8 * first:
            break
    train_s = time.perf_counter() - t0
    updates, update_ms = len(pairs), _event_ms(torch, pairs[:])
    replayed = r["num_steps_replayed"]
    profile = profiled_call(torch, algo.train)
    dtype = str(algo.buffer.sample_sequences(2, 4)["obs"].dtype)
    metrics = {k: v for k, v in r.items() if "/" in k or k ==
               "imagined_return"}
    d = algo.config.dims()
    algo.stop()
    emit({"phase": phase, "card": card,
          "kernels_launched": "none of K1-K4 (MLPs, GRU"
          + (", cuDNN convolutions)" if pixels else ")"),
          "model": {**d, "B": algo.config.batch_size_B,
                    "T": algo.config.batch_length_T,
                    "H": algo.config.horizon_H,
                    "training_ratio": algo.config.training_ratio},
          "iterations": iters, "train_s": train_s,
          "wm_total_first": first, "wm_total_last": last,
          "updates": updates, "update_ms": update_ms,
          "replayed_steps_per_sec": replayed / train_s,
          "replay_obs_dtype": dtype, "metrics": metrics,
          "profiled_iteration": profile,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    if first is None or not last < 0.8 * first:
        fail(f"{phase}: wm/total {first} -> {last} in {iters} iterations")
    bad = [k for k in DREAMER_METRICS if not math.isfinite(r.get(k, math.nan))]
    if bad:
        fail(f"{phase}: metrics missing or not finite: {bad}")
    if pixels and dtype != "uint8":
        fail(f"{phase}: replay holds {dtype} pixels, not uint8")
    release(torch)


def phase_dreamer(torch, card: str) -> None:
    _dreamer(torch, card, "dreamer_cartpole_S", "CartPole-v1",
             DREAMER_S, False)
    _dreamer(torch, card, "dreamer_pixel", "PixelCatch-v0",
             DREAMER_PIXEL, True)


def phase_multi_agent(torch, card: str) -> None:
    """Multi-agent PPO on CoordinationGame: a shared policy for
    MA_SHARED_ITERS iterations must end above 20 and 5 above its first;
    independent policies p0 and p1 for MA_INDEPENDENT_ITERS iterations
    must end above 20 with both policies' loss keys."""
    from ray_tpu_torch.rllib import MultiAgentPPOConfig

    algo = MultiAgentPPOConfig().build()
    on_cuda("multi_agent", *(algo.module[m].params
                             for m in algo.config.policies))
    secs, shared = [], []
    for _ in range(MA_SHARED_ITERS):
        t0 = time.perf_counter()
        shared.append(algo.train()["episode_return_mean"])
        secs.append(time.perf_counter() - t0)
    algo = (MultiAgentPPOConfig()
            .multi_agent(policies=["p0", "p1"],
                         policy_mapping_fn=lambda a: "p0" if a == "a0"
                         else "p1")
            .build())
    on_cuda("multi_agent", algo.module["p0"].params,
            algo.module["p1"].params)
    for _ in range(MA_INDEPENDENT_ITERS):
        t0 = time.perf_counter()
        r = algo.train()
        secs.append(time.perf_counter() - t0)
    keys = ("learner/p0/total_loss", "learner/p1/total_loss")
    emit({"phase": "multi_agent", "card": card,
          "kernels_launched": "none of K1-K4 (MLP towers)",
          "shared_first": shared[0], "shared_last": shared[-1],
          "independent_last": r["episode_return_mean"],
          "independent_loss_keys": all(k in r for k in keys),
          "iteration_s": spread(secs)})
    if not (shared[-1] > shared[0] + 5 and shared[-1] > 20):
        fail(f"multi_agent: shared policy {shared[0]} -> {shared[-1]}")
    if not (r["episode_return_mean"] > 20 and all(k in r for k in keys)):
        fail(f"multi_agent: independent policies end at "
             f"{r['episode_return_mean']}, keys {sorted(r)}")


def _ope_rows(torch, params, gen) -> list[dict]:
    """The JAX test's logged rows (8 episodes of 12 steps, obs from
    ``RandomState(0)``), actions sampled from `params` on their device."""
    from ray_tpu_torch.rllib import models

    rng = np.random.RandomState(0)
    rows = []
    for _ in range(8):
        for t in range(12):
            obs = rng.randn(4).astype(np.float32)
            a, logp, _ = models.sample_actions(
                params, torch.from_numpy(obs[None]).to(CARD), gen)
            rows.append({"obs": obs.tolist(), "action": int(a[0]),
                         "reward": float(rng.rand()), "done": t == 11,
                         "truncated": False, "logp": float(logp[0])})
    return rows


def phase_ope(torch, card: str) -> None:
    """IS, WIS and DR with a target policy on the card (its host arrays
    moved there by default) against the same params on the CPU
    (`device="cpu"`, OPE_TOL relative), on rows sampled from a
    behavior policy on the card; with the behavior policy as the
    target, the on-policy identity (1e-4)."""
    from ray_tpu_torch.interop import params_to_numpy
    from ray_tpu_torch.rllib import models, ope

    gen = torch.Generator(device=CARD)
    gen.manual_seed(1)
    behavior = models.init_mlp_policy(gen, 4, 2, (16,), device=CARD)
    other = models.init_mlp_policy(gen, 4, 2, (16,), device=CARD)
    on_cuda("ope", behavior, other)
    rows = _ope_rows(torch, behavior, gen)
    gamma = 0.97
    ret = float(np.mean([sum(gamma ** t * r["reward"]
                             for t, r in enumerate(ep))
                         for ep in ope.split_episodes(rows)]))
    out, worst, identity = {}, 0.0, 0.0
    for name in ("ImportanceSampling", "WeightedImportanceSampling",
                 "DoublyRobust"):
        cls = getattr(ope, name)
        for which, params in (("behavior", behavior), ("other", other)):
            # host arrays, as `get_weights()` gives them, go to the card
            # by default and to the CPU only where the caller names it
            host = params_to_numpy(params)
            est = cls(host, gamma)
            on_cuda("ope", est.params)
            v_card = est.estimate(rows)["v_target"]
            v_cpu = cls(host, gamma, device="cpu").estimate(
                rows)["v_target"]
            worst = max(worst, abs(v_card - v_cpu) / abs(v_cpu))
            out[f"{name}/{which}"] = {"card": v_card, "cpu": v_cpu}
            if which == "behavior":
                identity = max(identity, abs(v_card - ret) / abs(ret))
    emit({"phase": "ope", "card": card,
          "kernels_launched": "none of K1-K4 (an MLP forward)",
          "behavior_return": ret, "estimates": out,
          "card_vs_cpu_rel": worst, "tol": OPE_TOL,
          "on_policy_identity_rel": identity})
    if worst > OPE_TOL:
        fail(f"ope: card against CPU {worst} relative, above {OPE_TOL}")
    if identity > 1e-4:
        fail(f"ope: the on-policy estimates miss the behavior return by "
             f"{identity} relative")


def phase_more_rl(torch, card: str) -> dict:
    """Phase 11, the launch counters zeroed just before and read just
    after: no K1-K4 launch may happen on these paths."""
    counters = _reset_counters()
    phase_f3_determinism(torch, card)
    phase_impala_cartpole(torch, card)
    phase_appo_cartpole(torch, card)
    phase_sac_pendulum(torch, card)
    phase_dreamer(torch, card)
    phase_multi_agent(torch, card)
    phase_ope(torch, card)
    launches = launch_counts(counters)
    if any(v for k, v in launches.items() if k != "paged_attention_by_shape"):
        fail(f"more RL: K1-K4 launched on the RL paths: {launches}")
    return launches


def _tune_runtime(torch, ray) -> dict:
    """The core API on the card in local mode: a num_gpus=1 task returns
    a CUDA tensor by reference, and an actor holding GPT-2-small's
    params on the card answers two calls in order. (Checks run here, on
    the main thread: `fail` in an actor's thread would end that thread
    only.)"""
    from ray_tpu_torch.models.gpt2 import GPT2Config, count_params, init_gpt2
    from ray_tpu_torch.util import tree

    @ray.remote(num_gpus=1)
    def make(n):
        t = torch.arange(n, device="cuda", dtype=torch.float32)
        return t, t.data_ptr()

    ref = make.remote(4096)
    t, ptr = ray.get(ref)
    if not (t.is_cuda and t.data_ptr() == ptr and ray.get(ref)[0] is t):
        fail(f"tune_gpt2: the task's tensor came back as a copy or off the "
             f"card ({t.device}, {t.data_ptr()} against {ptr})")
    if not torch.equal(t, torch.arange(4096, device="cuda",
                                       dtype=torch.float32)):
        fail("tune_gpt2: the task's tensor holds the wrong values")

    @ray.remote(num_gpus=1)
    class Params:
        def __init__(self, seed):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            self.params = init_gpt2(gen, GPT2Config.small())
            self.calls = 0

        def count(self):
            self.calls += 1
            return self.calls, count_params(self.params), sorted(
                {str(x.device) for x in tree.leaves(self.params)})

        def wte_sum(self):
            self.calls += 1
            return self.calls, float(self.params["wte"].sum())

    actor = Params.remote(0)
    first, second = actor.count.remote(), actor.wte_sum.remote()
    (i1, n_params, devices), (i2, wte_sum) = ray.get([first, second])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    want = float(init_gpt2(gen, GPT2Config.small())["wte"].sum())
    if (i1, i2) != (1, 2) or wte_sum != want or devices != ["cuda:0"]:
        fail(f"tune_gpt2: actor calls answered as {(i1, i2)}, params on "
             f"{devices}, wte sum {wte_sum} against {want}")
    ray.kill(actor)
    del ref, t, first, second, actor
    return {"task_tensor_by_reference": True, "actor_calls_in_order": True,
            "actor_n_params": n_params}


def _tune_trial(torch, record, live, config):
    """One trial: GPT-2-small from seed 0 on TRAIN_BATCH, adamw at the
    trial's lr; a `save_train_state` checkpoint at each step in
    ``config["ckpt_at"]`` (kept by a CheckpointManager, one a trial),
    resumed from `tune.get_checkpoint()` through `load_train_state`.
    Appends one dict a step to `record`, with how many trials were in
    their loops (`live`, a set within one process, or None) when it
    ended, its wall-clock start and end, this process's pid, peak memory
    and K1-K3 launches so far; checks are the caller's."""
    from ray_tpu_torch import train, tune
    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_loss, init_gpt2
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.train.checkpointing import (
        load_train_state,
        save_train_state,
    )
    from ray_tpu_torch.util import tree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPT2Config.small()
    B, T = TRAIN_BATCH
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tx = train.adamw(config["lr"], weight_decay=0.1)
    state = train.TrainState.create(init_gpt2(gen, cfg), tx)
    toks = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    state_bytes = sum(t.nbytes for t in tree.leaves(state.params)
                      + tree.leaves(state.opt_state.mu)
                      + tree.leaves(state.opt_state.nu))
    name = f"{config['run']}_lr_{config['lr']}"
    ckpt = tune.get_checkpoint()
    load_s = None
    if ckpt is not None:
        t0 = time.perf_counter()
        state = load_train_state(ckpt.path, state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    manager = train.CheckpointManager(
        os.path.join(TUNE_DIR, "trials", name),
        train.CheckpointConfig(num_to_keep=1))
    step = train.make_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx)
    live = set() if live is None else live
    live.add(name)
    try:
        while state.step < config["steps"]:
            start = time.time()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            loss = float(m["loss"])
            row = {"lr": config["lr"], "step": state.step, "loss": loss,
                   "ms": (time.perf_counter() - t0) * 1e3,
                   "start": start, "end": time.time(),
                   "at_once": len(live), "resumed": ckpt is not None,
                   "load_s": load_s, "bytes": state_bytes, "save_s": None,
                   "on_cuda": all(t.is_cuda
                                  for t in tree.leaves(state.params)),
                   "pid": os.getpid(),
                   "peak": torch.cuda.max_memory_allocated(),
                   "launches": {"flash_fwd": fa.LAUNCHES.count,
                                "flash_dq": fa.LAUNCHES_DQ.count,
                                "flash_dkv": fa.LAUNCHES_DKV.count}}
            load_s = None
            shipped = None
            if state.step in config["ckpt_at"]:
                t0 = time.perf_counter()
                d = os.path.join(TUNE_DIR, "staging", name)
                save_train_state(state, d)
                shipped = manager.register(
                    train.Checkpoint(d), {"loss": loss, "step": state.step})
                row["save_s"] = time.perf_counter() - t0
            record.append(row)
            tune.report({"loss": loss, "step": state.step},
                        checkpoint=shipped)
    finally:
        live.discard(name)


def _trial_status(exp_dir: str) -> dict:
    with open(os.path.join(exp_dir, "tuner_state.json")) as f:
        return {t["config"]["lr"]: t["status"]
                for t in json.load(f)["trials"]}


def phase_tune_gpt2(torch, keep: dict | None = None) -> dict:
    """Phase 12: the core API in local mode on the card, an ASHA sweep
    of GPT-2-small's learning rate through the Tuner (trials training at
    once through K1-K3, checkpointing their train state), and a trial
    restored from its checkpoint with bitwise-equal losses. The launch
    counters are zeroed just before the sweep and read after the sweep
    and after the restore. `keep`, if given, takes the step ms two at
    once and alone (phase 15 prints them beside its trial processes')."""
    import functools
    import shutil

    import ray_tpu_torch as ray
    from ray_tpu_torch import tune
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.train import RunConfig

    t_phase = time.perf_counter()
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    ray.init(local_mode=True, num_gpus=1)
    try:
        row = {"phase": "tune_gpt2", **_tune_runtime(torch, ray)}
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        sweep: list[dict] = []
        counters = _reset_counters()
        t0 = time.perf_counter()
        sweep_grid = tune.Tuner(
            functools.partial(_tune_trial, torch, sweep, set()),
            param_space={"lr": tune.grid_search(list(TUNE_LRS)),
                         "run": "sweep", "steps": TUNE_MAX_T,
                         "ckpt_at": list(range(TUNE_CKPT_EVERY,
                                               TUNE_MAX_T + 1,
                                               TUNE_CKPT_EVERY))},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min",
                max_concurrent_trials=TUNE_CONCURRENT,
                scheduler=tune.ASHAScheduler(
                    max_t=TUNE_MAX_T, grace_period=TUNE_GRACE,
                    reduction_factor=TUNE_RF)),
            run_config=RunConfig(name="sweep", storage_path=TUNE_DIR),
        ).fit()
        sweep_s = time.perf_counter() - t0
        sweep_launches = launch_counts(counters)
        status = _trial_status(os.path.join(TUNE_DIR, "sweep"))
        shutil.rmtree(os.path.join(TUNE_DIR, "trials"))

        resume: list[dict] = []
        trainable = functools.partial(_tune_trial, torch, resume, set())
        exp = os.path.join(TUNE_DIR, "resume")
        first_grid = tune.Tuner(
            trainable,
            param_space={"lr": tune.grid_search([TUNE_RESUME_LR]),
                         "run": "resume", "steps": TUNE_MAX_T,
                         "ckpt_at": [TUNE_CKPT_EVERY]},
            tune_config=tune.TuneConfig(metric="loss", mode="min"),
            run_config=RunConfig(name="resume", storage_path=TUNE_DIR),
        ).fit()
        n_first = len(resume)
        with open(os.path.join(exp, "tuner_state.json")) as f:
            state = json.load(f)
        state["trials"][0]["status"] = "RUNNING"  # as if it died at the end
        with open(os.path.join(exp, "tuner_state.json"), "w") as f:
            json.dump(state, f)
        restored_grid = tune.Tuner.restore(exp, trainable).fit()
        launches = launch_counts(counters)
        peak = torch.cuda.max_memory_allocated()
    finally:
        ray.shutdown()
        shutil.rmtree(TUNE_DIR, ignore_errors=True)
    release(torch)

    for what, g in (("sweep", sweep_grid), ("resume", first_grid),
                    ("restore", restored_grid)):
        if g.errors:
            fail(f"tune_gpt2: a {what} trial failed: {g.errors[0].error}")
    trials: dict[float, list] = {}
    for r in sweep:
        trials.setdefault(r["lr"], []).append(r)
    losses = [r["loss"] for r in sweep + resume]
    if not all(math.isfinite(x) for x in losses):
        fail(f"tune_gpt2: non-finite losses {losses}")
    if not all(r["on_cuda"] for r in sweep + resume):
        fail("tune_gpt2: a trial's params left the card")
    if not any(r["at_once"] == TUNE_CONCURRENT for r in sweep):
        fail(f"tune_gpt2: no {TUNE_CONCURRENT} trials trained at once")
    last = {lr: rows[-1]["step"] for lr, rows in trials.items()}
    if sorted(last) != sorted(TUNE_LRS) or not (
            min(last.values()) < TUNE_MAX_T == max(last.values())):
        fail(f"tune_gpt2: ASHA cut no trial, or none finished: steps "
             f"{last}, status {status}")
    best = min(trials, key=lambda lr: trials[lr][-1]["loss"])
    if not trials[best][-1]["loss"] < trials[best][0]["loss"]:
        fail(f"tune_gpt2: the best trial's loss did not fall: "
             f"{[r['loss'] for r in trials[best]]}")
    L = GPT2Config.small().n_layer
    per_step = {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
                "paged_attention": 0}
    for what, got, steps in (("sweep", sweep_launches, len(sweep)),
                             ("sweep and resume", launches,
                              len(sweep) + len(resume))):
        want = {k: v * steps for k, v in per_step.items()}
        if {k: got[k] for k in want} != want:
            fail(f"tune_gpt2: {what} launches {got}, want {want} "
                 f"({steps} steps)")
    again = resume[n_first:]
    before = {r["step"]: r["loss"] for r in resume[:n_first]}
    if [r["step"] for r in again] != list(
            range(TUNE_CKPT_EVERY + 1, TUNE_MAX_T + 1)) or \
            not all(r["resumed"] for r in again):
        fail(f"tune_gpt2: the restored trial ran steps "
             f"{[r['step'] for r in again]}, want "
             f"{TUNE_CKPT_EVERY + 1}-{TUNE_MAX_T} from its checkpoint")
    unequal = [(r["step"], r["loss"], before[r["step"]]) for r in again
               if r["loss"] != before[r["step"]]]
    if unequal:
        fail(f"tune_gpt2: restored losses differ from the first run's "
             f"(step, restored, first): {unequal}")
    saves = [r["save_s"] for r in sweep + resume if r["save_s"]]
    loads = [r["load_s"] for r in again if r["load_s"]]
    gb = sweep[0]["bytes"] / 1e9
    two = [r["ms"] for r in sweep if r["step"] > 1 and r["at_once"] == 2]
    alone = [r["ms"] for r in resume[:n_first] if r["step"] > 1]
    row.update({
        "model": "gpt2-small", "batch": TRAIN_BATCH, "lrs": TUNE_LRS,
        "scheduler": f"ASHA(max_t={TUNE_MAX_T}, grace={TUNE_GRACE}, "
                     f"rf={TUNE_RF})", "concurrent": TUNE_CONCURRENT,
        "trials": {str(lr): {"steps": rows[-1]["step"],
                             "losses": [r["loss"] for r in rows],
                             "asha": status[lr]}
                   for lr, rows in sorted(trials.items())},
        "best_lr": best, "sweep_steps": len(sweep), "sweep_s": sweep_s,
        "resume_losses": [r["loss"] for r in again],
        "resume_losses_bitwise_equal": True,
        "step_ms_two_at_once": spread(two) if two else "none ran at once",
        "step_ms_alone": spread(alone),
        "step_ms_note": "host clock around one step and the loss's read",
        "slowest_steps": [(r["lr"], r["step"], r["at_once"], r["ms"])
                          for r in sorted(sweep, key=lambda r: -r["ms"])[:4]],
        "checkpoint_gb": gb, "saves": len(saves), "save_s": spread(saves),
        "save_gb_per_s": gb / float(np.median(saves)),
        "load_s": loads, "load_gb_per_s": [gb / x for x in loads],
        "launches": launches, "launches_per_step": per_step,
        "max_memory_allocated": peak,
        "phase_s": time.perf_counter() - t_phase})
    emit(row)
    if keep is not None:
        keep.update(two_at_once=row["step_ms_two_at_once"],
                    alone=row["step_ms_alone"])
    return launches


# ------------------------------------------------------------ phase 13


def _split_tokens(b: dict) -> dict:
    return {"tokens": b["tokens"][:, :-1], "targets": b["tokens"][:, 1:]}


def _token_pipeline(rd):
    """read_json over DATA_DIR, the seeded shuffle, the input/target
    split: the dataset phase 13 iterates."""
    return (rd.read_json(DATA_DIR).random_shuffle(seed=DATA_SEED)
            .map_batches(_split_tokens))


def _gpt2_run(torch, cfg, batches, steps: int, fetch_wrap=None):
    """GPT-2-small's train step (train's recipe, params from seed 0) over
    `steps` batches drawn from the iterator `batches`, each fetch inside
    ``fetch_wrap()`` if given, the launch counters zeroed just before
    and read just after: (losses, step ms sorted, launches)."""
    from ray_tpu_torch.models.gpt2 import gpt2_loss, init_gpt2
    from ray_tpu_torch.train import TrainState, adamw, make_train_step

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tx = adamw(3e-4, weight_decay=0.1)
    state = TrainState.create(init_gpt2(gen, cfg), tx)
    step = make_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx)
    torch.cuda.synchronize()
    counters = _reset_counters()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(steps + 1)]
    losses = []
    events[0].record()
    for i in range(steps):
        with (fetch_wrap() if fetch_wrap else contextlib.nullcontext()):
            batch = next(batches)
        state, m = step(state, batch)
        losses.append(m["loss"])
        events[i + 1].record()
    torch.cuda.synchronize()
    launches = launch_counts(counters)
    step_ms = sorted(events[i].elapsed_time(events[i + 1])
                     for i in range(steps))
    del state, step
    release(torch)
    return [float(x) for x in losses], step_ms, launches


def phase_data_gpt2(torch, card: str, train_keep: dict) -> dict:
    """Phase 13a: the data layer feeding GPT-2-small's training step on
    the card. DATA_ROWS seeded token rows go through write_jsonl, then
    read_json (the native line scanner), random_shuffle(seed=DATA_SEED),
    map_batches into inputs and targets and iter_torch_batches onto the
    card (pinned host copies), into DATA_WARMUP + DATA_STEPS train steps
    (bf16, full remat), each fetch inside ``spmd.data_wait()`` with the
    step waterfall on (the main path; its launches are the phase's),
    then the same with the waterfall off. Fail unless every batch leaf
    is a CUDA int64 tensor of TRAIN_BATCH's shape, the batches equal the
    same pipeline's on the CPU bit for bit and in order, K1/K2/K3 launch
    exactly 24/12/12 a step, every loss is finite and both runs' losses
    equal those of the same steps fed the CPU pipeline's batches copied
    to the card directly, bit for bit."""
    import shutil

    import ray_tpu_torch as ray
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.data import lineio
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.train import spmd

    t_phase = time.perf_counter()
    cfg = GPT2Config.small()
    B, T = TRAIN_BATCH
    steps = DATA_WARMUP + DATA_STEPS
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                            (DATA_ROWS, T + 1))
    t0 = time.perf_counter()
    native = lineio.native()  # builds csrc/lineio.cc on first call
    lineio_build_s = time.perf_counter() - t0
    if not native:
        fail("data_gpt2: the native line scanner did not build")
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    ray.init(local_mode=True, num_gpus=1)
    try:
        t0 = time.perf_counter()
        files = rd.from_numpy({"tokens": toks}, parallelism=8).write_jsonl(
            DATA_DIR)
        write_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(f) for f in files)
        t0 = time.perf_counter()
        on_card = list(_token_pipeline(rd).iter_torch_batches(
            batch_size=B))
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = list(_token_pipeline(rd).iter_torch_batches(
            batch_size=B, device="cpu"))
        ingest_cpu_s = time.perf_counter() - t0
        if len(on_card) != DATA_ROWS // B or len(on_cpu) != len(on_card):
            fail(f"data_gpt2: {len(on_card)} batches on the card, "
                 f"{len(on_cpu)} on the CPU, want {DATA_ROWS // B}")
        for i, (g, c) in enumerate(zip(on_card, on_cpu)):
            for k in ("tokens", "targets"):
                x = g[k]
                if not (x.is_cuda and x.dtype == torch.int64
                        and tuple(x.shape) == (B, T)):
                    fail(f"data_gpt2: batch {i} {k} is {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
                if not torch.equal(x.cpu(), c[k]):
                    fail(f"data_gpt2: batch {i} {k} differs from the CPU "
                         f"pipeline's")
        del on_card

        torch.cuda.reset_peak_memory_stats()
        spmd.waterfall.reset()
        spmd.enable_step_waterfall(True)
        try:
            losses, step_ms, launches = _gpt2_run(
                torch, cfg, _token_pipeline(rd).iter_torch_batches(
                    batch_size=B), steps, spmd.data_wait)
            fall = spmd.waterfall.summary()
        finally:
            spmd.enable_step_waterfall(False)
            spmd.waterfall.reset()
        peak = torch.cuda.max_memory_allocated()
        # the same data-fed run with the waterfall off (data_wait() is
        # then two clock reads): the step without the instrumentation's
        # sync, beside the directly fed run
        losses_off, off_ms, off_launches = _gpt2_run(
            torch, cfg, _token_pipeline(rd).iter_torch_batches(
                batch_size=B), steps, spmd.data_wait)
        direct = iter([{k: torch.from_numpy(v.numpy()).to("cuda")
                        for k, v in b.items()} for b in on_cpu])
        losses_direct, direct_ms, direct_launches = _gpt2_run(
            torch, cfg, direct, steps)
    finally:
        ray.shutdown()
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    L = cfg.n_layer
    per_step = {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
                "paged_attention": 0}
    for what, got in (("data-fed", launches),
                      ("data-fed, waterfall off", off_launches),
                      ("direct", direct_launches)):
        want = {k: v * steps for k, v in per_step.items()}
        if {k: got[k] for k in want} != want:
            fail(f"data_gpt2: {what} launches {got}, want {want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"data_gpt2: non-finite losses {losses}")
    if not losses == losses_off == losses_direct:
        fail(f"data_gpt2: data-fed losses {losses} (waterfall off: "
             f"{losses_off}) differ from the directly fed {losses_direct}")
    phases = fall["phases"]
    emit({"phase": "data_gpt2", "card": card, "model": "gpt2-small",
          "batch": B, "seq": T, "rows": DATA_ROWS, "steps": steps,
          "native_lineio": native, "lineio_build_s": lineio_build_s,
          "jsonl_files": len(files), "jsonl_bytes": nbytes,
          "write_jsonl_s": write_s,
          "ingest_rows_per_s": DATA_ROWS / ingest_s,
          "ingest_s": ingest_s, "ingest_cpu_s": ingest_cpu_s,
          "batches_bitwise_equal_to_cpu": True,
          "step_ms": spread(step_ms),
          "step_ms_waterfall_off": spread(off_ms),
          "step_ms_direct": spread(direct_ms),
          "train_phase_step_ms": train_keep.get("step_ms"),
          "data_wait_ms_per_step": 1e3 * phases.get("data_wait", 0.0)
          / max(1, fall["steps"]),
          "waterfall_ms_per_step": {k: 1e3 * v / max(1, fall["steps"])
                                    for k, v in phases.items()},
          "waterfall_note": "the waterfall syncs the card once a step",
          "losses": losses, "losses_bitwise_equal_to_direct": True,
          "launches": launches, "launches_per_step": per_step,
          "max_memory_allocated": peak,
          "phase_s": time.perf_counter() - t_phase})
    return launches


def phase_offline_rl(torch, card: str) -> dict:
    """Phase 13b: offline RL over the data layer on the card, the launch
    counters zeroed just before and read just after (no K1-K4 launch:
    MLPs). A CartPole PPO expert (phase 10's recipe) trained until its
    best return passes OFFLINE_EXPERT_RETURN, as the JAX offline test
    trains it, and at least to phase 10's PPO_TARGET; OFFLINE_EPISODES of
    its episodes recorded as jsonl; BC and MARWIL OFFLINE_ITERS
    iterations each (BC's loss must fall, each must score above
    OFFLINE_EVAL_BAR); importance sampling over the recording read back
    (finite v_target, v_behavior > 0, at least 4 episodes); CQL on
    CQL_STEPS recorded Pendulum transitions at cql_alpha 10 and 0 (a
    finite Bellman loss, ood_gap > 0 at 10 and above the gap at 0, the
    four metrics). The bars are the JAX tests'."""
    import shutil

    import ray_tpu_torch as ray
    from ray_tpu_torch.rllib import (BCConfig, CQLConfig, MARWILConfig,
                                     PPOConfig, load_offline_dataset,
                                     record_continuous_experiences,
                                     record_experiences)
    from ray_tpu_torch.rllib.ope import ImportanceSampling

    t_phase = time.perf_counter()
    shutil.rmtree(OFFLINE_DIR, ignore_errors=True)
    exp, pend = (os.path.join(OFFLINE_DIR, d) for d in ("cartpole",
                                                        "pendulum"))
    row = {"phase": "offline_rl", "card": card}
    ray.init(local_mode=True, num_gpus=1)
    counters = _reset_counters()
    try:
        t0 = time.perf_counter()
        algo = (PPOConfig().environment("CartPole-v1")
                .env_runners(**PPO_CARTPOLE)
                .training(**PPO_CARTPOLE_TRAINING)).build()
        best, iters = float("-inf"), 0
        for iters in range(1, OFFLINE_EXPERT_ITERS + 1):
            m = algo.train()["episode_return_mean"]
            if m == m:
                best = max(best, m)
            if best > OFFLINE_EXPERT_RETURN:
                break
        expert = algo.get_weights()
        algo.stop()
        del algo
        row["expert"] = {"iterations": iters, "best": best,
                         "s": time.perf_counter() - t0}
        if best < PPO_TARGET:
            fail(f"offline_rl: the expert's best return {best} after "
                 f"{iters} iterations is below {PPO_TARGET}")

        t0 = time.perf_counter()
        files = record_experiences("CartPole-v1", OFFLINE_EPISODES, exp,
                                   params=expert, fmt="jsonl")
        row["record"] = {"files": len(files),
                         "s": time.perf_counter() - t0}
        for name, cfg in (("bc", BCConfig()), ("marwil", MARWILConfig())):
            t0 = time.perf_counter()
            a = cfg.offline_data(exp).training(lr=1e-3).build()
            on_cuda(f"offline_rl {name}", a.params)
            losses = [a.train()["learner/loss"]
                      for _ in range(OFFLINE_ITERS)]
            train_s = time.perf_counter() - t0
            ev = a.evaluate("CartPole-v1",
                            num_episodes=OFFLINE_EVAL_EPISODES)
            row[name] = {"rows": len(a._data["actions"]),
                         "loss_first": losses[0], "loss_last": losses[-1],
                         "train_s": train_s,
                         "iteration_s": train_s / OFFLINE_ITERS,
                         "eval": ev}
            if name == "bc":
                cloned = a.get_weights()
                if not losses[-1] < losses[0]:
                    fail(f"offline_rl: BC's loss did not fall: {losses}")
            if not ev["episode_return_mean"] > OFFLINE_EVAL_BAR:
                fail(f"offline_rl: {name} scored "
                     f"{ev['episode_return_mean']}, not above "
                     f"{OFFLINE_EVAL_BAR}")
            a.stop()

        rows = load_offline_dataset(exp).take_all()
        estimator = ImportanceSampling(cloned, gamma=0.99)
        on_cuda("offline_rl ope", estimator.params)
        est = estimator.estimate(rows)
        row["ope_is"] = est
        if not (math.isfinite(est["v_target"]) and est["v_behavior"] > 0
                and est["num_episodes"] >= 4):
            fail(f"offline_rl: importance sampling over the recording: "
                 f"{est}")

        t0 = time.perf_counter()
        record_continuous_experiences("Pendulum-v1", CQL_STEPS, pend,
                                      seed=3)
        row["cql_record_s"] = time.perf_counter() - t0
        gaps, cql_rows = {}, {}
        for alpha in (10.0, 0.0):
            t0 = time.perf_counter()
            a = (CQLConfig().offline_data(pend).environment("Pendulum-v1")
                 .training(cql_alpha=alpha, **CQL_TRAINING)).build()
            on_cuda("offline_rl cql", a.params, a.target_q)
            for _ in range(CQL_ITERS):
                r = a.train()
            missing = [k for k in ("learner/bellman_loss",
                                   "learner/conservative_gap",
                                   "learner/actor_loss", "alpha")
                       if k not in r]
            if missing:
                fail(f"offline_rl: CQL metrics missing: {missing}")
            if not math.isfinite(r["learner/bellman_loss"]):
                fail(f"offline_rl: CQL Bellman loss {r}")
            gaps[alpha] = a.ood_gap()
            train_s = time.perf_counter() - t0
            cql_rows[str(alpha)] = {
                "last": {k: r[k] for k in ("learner/bellman_loss",
                                           "learner/conservative_gap",
                                           "learner/actor_loss", "alpha")},
                "ood_gap": gaps[alpha], "train_s": train_s,
                "updates_per_s": CQL_ITERS * CQL_TRAINING[
                    "updates_per_iteration"] / train_s}
            a.stop()
        row["cql"] = cql_rows
        if not gaps[10.0] > 0.0:
            fail(f"offline_rl: CQL's ood_gap at cql_alpha=10 is "
                 f"{gaps[10.0]}, not above 0")
        if not gaps[10.0] > gaps[0.0]:
            fail(f"offline_rl: CQL's gap at cql_alpha=10 ({gaps[10.0]}) "
                 f"is not above the gap at 0 ({gaps[0.0]})")
        launches = launch_counts(counters)
    finally:
        ray.shutdown()
        shutil.rmtree(OFFLINE_DIR, ignore_errors=True)
    if any(v for k, v in launches.items() if k != "paged_attention_by_shape"):
        fail(f"offline_rl: K1-K4 launched on the offline RL path: "
             f"{launches}")
    row.update({"launches": launches,
                "kernels_launched": "none of K1-K4 (MLPs)",
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "phase_s": time.perf_counter() - t_phase})
    emit(row)
    return launches


# ------------------------------------------------------------ phase 14


class ClusterWorker:
    """An actor of phase 14, defined in this script (``__main__``), so
    the cluster pickles it by value: what its worker process sees, gets
    and trains."""

    def __init__(self):
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if torch.cuda.is_available():
            torch.cuda.set_device(0)

    def info(self) -> dict:
        import torch

        n = torch.cuda.device_count()
        return {"pid": os.getpid(), "device_count": n,
                "name": torch.cuda.get_device_name(0) if n else None,
                "cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES")}

    def timed_get(self, refs: list) -> dict:
        """ray.get of refs[0] in this process, timed to the data's
        arrival on its device."""
        import torch

        import ray_tpu_torch as ray

        t0 = time.perf_counter()
        x = ray.get(refs[0], timeout=CLUSTER_WAIT_S)
        if x.is_cuda:
            torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        return {"s": sec, "device": x.device.type, "nbytes":
                x.numel() * x.element_size(),
                "checksum": float(x.view(-1)[::4096].double().sum())}

    def train(self, refs: list, steps: int) -> dict:
        """GPT-2-small's train step (train's recipe) from the params and
        batch in `refs`, `steps` steps with this process's launch
        counters zeroed just before and read just after."""
        import torch

        import ray_tpu_torch as ray
        from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_loss
        from ray_tpu_torch.train import TrainState, adamw, make_train_step
        from ray_tpu_torch.util import tree

        t0 = time.perf_counter()
        params, batch = ray.get(refs, timeout=CLUSTER_WAIT_S)
        torch.cuda.synchronize()
        get_s = time.perf_counter() - t0
        cfg = GPT2Config.small()
        tx = adamw(3e-4, weight_decay=0.1)
        state = TrainState.create(params, tx)
        step = make_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx)
        counters = _reset_counters()
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(steps + 1)]
        losses = []
        events[0].record()
        for i in range(steps):
            state, m = step(state, batch)
            losses.append(m["loss"])
            events[i + 1].record()
        torch.cuda.synchronize()
        launches = launch_counts(counters)
        return {"pid": os.getpid(), "get_s": get_s,
                "params_on": sorted({t.device.type
                                     for t in tree.leaves(params)}),
                "losses": [float(x) for x in losses],
                "step_ms": [events[i].elapsed_time(events[i + 1])
                            for i in range(steps)],
                "launches": launches}

    def crash(self) -> None:
        """Exit this worker process in the middle of a method."""
        import torch

        torch.ones(1, device="cuda").sum().item()
        os._exit(1)


def _percentiles_us(xs) -> dict:
    return {"p50": float(np.percentile(xs, 50)) * 1e6,
            "p90": float(np.percentile(xs, 90)) * 1e6}


def _round_trips(fn, warmup: int, calls: int) -> list:
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def _worker_pids(rt) -> dict:
    """pid -> spawn-to-ready seconds of every worker of the nodelet."""
    st = rt.client.call(rt.nodelet_address, "node_stats", {}, timeout=10)
    return {w["pid"]: w["ready_s"] for w in st["workers"]}


def _wait_gpu_available(ray, want: float) -> float:
    deadline = time.monotonic() + 15
    got = None
    while time.monotonic() < deadline:
        got = ray.available_resources().get("GPU", 0.0)
        if got == want:
            return got
        time.sleep(0.2)
    return got


def phase_cluster(torch, card: str, train_keep: dict) -> dict:
    """Phase 14: the cluster runtime on the card's machine, then
    GPT-2-small trained in a GPU actor's process (see the docstring);
    returns the actor's launches (the path cluster_gpt2)."""
    import tempfile

    import ray_tpu_torch as ray
    from ray_tpu_torch.core import object_store
    from ray_tpu_torch.core.api import _global_runtime
    from ray_tpu_torch.core.gcs_client import GcsClient
    from ray_tpu_torch.models.gpt2 import GPT2Config, count_params, \
        gpt2_loss, init_gpt2
    from ray_tpu_torch.train import TrainState, adamw, make_train_step

    t_phase = time.perf_counter()
    release(torch)
    shm = os.statvfs(object_store._SHM_DIR)
    shm_bytes, shm_free = shm.f_blocks * shm.f_frsize, \
        shm.f_bavail * shm.f_frsize
    print(f"cluster: {object_store._SHM_DIR} {shm_bytes} bytes, "
          f"{shm_free} free; store capacity {CLUSTER_STORE_BYTES}",
          flush=True)
    os.environ["RAY_TPU_OBJECT_STORE_BYTES"] = str(CLUSTER_STORE_BYTES)
    t0 = time.perf_counter()
    try:
        ray.init()
    except (MemoryError, RuntimeError) as e:
        fail(f"cluster: init() failed: {e}")
    finally:
        os.environ.pop("RAY_TPU_OBJECT_STORE_BYTES", None)
    init_s = time.perf_counter() - t0
    rt = _global_runtime()
    store_name = rt.store.name
    kind = object_store.kind()
    print(f"cluster: store {store_name} kind {kind}", flush=True)
    seen_pids: set = set()
    try:
        if kind != "native":
            fail(f"cluster: the object store is {kind}, not native")
        res = ray.cluster_resources()
        if res.get("GPU") != torch.cuda.device_count():
            fail(f"cluster: cluster_resources() GPU {res.get('GPU')}, "
                 f"torch.cuda.device_count() {torch.cuda.device_count()}")

        # -- core verbs
        @ray.remote(num_cpus=0.1)
        def noop():
            return None

        @ray.remote(num_cpus=0)
        class Echo:
            def ping(self):
                return None

        echo = Echo.remote()
        task_rtt = _round_trips(
            lambda: ray.get(noop.remote(), timeout=CLUSTER_WAIT_S),
            CLUSTER_RTT_WARMUP, CLUSTER_RTT_CALLS)
        actor_rtt = _round_trips(
            lambda: ray.get(echo.ping.remote(), timeout=CLUSTER_WAIT_S),
            CLUSTER_RTT_WARMUP, CLUSTER_RTT_CALLS)
        ray.kill(echo)

        @ray.remote(num_gpus=0)
        def devices_without_gpu():
            import torch

            return torch.cuda.device_count()

        @ray.remote(num_gpus=1)
        def devices_with_gpu():
            import torch

            return torch.cuda.device_count(), torch.cuda.get_device_name(0)

        # both at once: two worker processes start side by side
        n0, (n1, name1) = ray.get([devices_without_gpu.remote(),
                                   devices_with_gpu.remote()],
                                  timeout=CLUSTER_WAIT_S)
        if n0 != 0:
            fail(f"cluster: a num_gpus=0 task sees {n0} devices")
        if n1 != torch.cuda.device_count() or \
                name1 != torch.cuda.get_device_name(0):
            fail(f"cluster: a num_gpus=1 task sees {n1} devices ({name1})")

        # two half-GPU actors share the card; a third waits
        Half = ray.remote(num_gpus=0.5)(ClusterWorker)
        halves = [Half.remote(), Half.remote()]
        infos = ray.get([h.info.remote() for h in halves],
                        timeout=CLUSTER_WAIT_S)
        seen_pids.update(i["pid"] for i in infos)
        if any(i["device_count"] != 1 for i in infos) or \
                infos[0]["pid"] == infos[1]["pid"]:
            fail(f"cluster: the two num_gpus=0.5 actors see {infos}")
        third = Half.remote()
        gcs = GcsClient()
        time.sleep(2.0)
        waiting = gcs.get_actor_info(third._actor_id.binary())["state"]
        if waiting != "PENDING":
            fail(f"cluster: a third num_gpus=0.5 actor is {waiting} while "
                 f"two hold the card")
        ray.kill(halves[0])
        info3 = ray.get(third.info.remote(), timeout=CLUSTER_WAIT_S)
        seen_pids.add(info3["pid"])
        if info3["device_count"] != 1:
            fail(f"cluster: the third half-GPU actor sees {info3}")
        for h in (halves[1], third):
            ray.kill(h)
        if _wait_gpu_available(ray, 1.0) != 1.0:
            fail("cluster: GPU not back to 1.0 after the half actors")

        # -- put/get of 256 MiB, CPU and CUDA, read in a GPU actor; the
        # same actor then trains and, last, crashes and restarts (one
        # card process for the three)
        Gpu = ray.remote(num_gpus=1, max_restarts=1)(ClusterWorker)
        reader = Gpu.remote()
        seen_pids.add(ray.get(reader.info.remote(),
                              timeout=CLUSTER_WAIT_S)["pid"])
        moves = {}
        for dev in ("cpu", "cuda"):
            x = torch.arange(CLUSTER_PUT_BYTES // 4, dtype=torch.float32,
                             device=dev)
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = ray.put(x)
            put_s = time.perf_counter() - t0
            got = ray.get(reader.timed_get.remote([ref]),
                          timeout=CLUSTER_WAIT_S)
            want = float(x.view(-1)[::4096].double().sum())
            if got["device"] != dev or got["checksum"] != want:
                fail(f"cluster: a {dev} tensor read back as {got}, "
                     f"checksum want {want}")
            moves[dev] = {"bytes": CLUSTER_PUT_BYTES, "put_s": put_s,
                          "get_s": got["s"],
                          "put_gbps": CLUSTER_PUT_BYTES / put_s / 1e9,
                          "get_gbps": CLUSTER_PUT_BYTES / got["s"] / 1e9}
            del ref, x
        spawn = _worker_pids(rt)
        seen_pids.update(spawn)
        ready = [s for s in spawn.values() if s is not None]
        emit({"phase": "cluster", "card": card, "shm_bytes": shm_bytes,
              "shm_free_bytes": shm_free,
              "store_capacity": CLUSTER_STORE_BYTES, "store_kind": kind,
              "init_s": init_s, "cluster_resources": res,
              "task_rtt_us": _percentiles_us(task_rtt),
              "actor_rtt_us": _percentiles_us(actor_rtt),
              "rtt_calls": CLUSTER_RTT_CALLS, "put_get": moves,
              "spawn_to_ready_s": spread(ready) if ready else None,
              "workers_spawned": len(spawn),
              "gpu0_task_devices": n0, "gpu1_task_devices": n1,
              "half_gpu_actors": [i["pid"] for i in infos],
              "third_half_actor_while_two_run": waiting})

        # -- cluster_gpt2
        cfg = GPT2Config.small()
        B, T = TRAIN_BATCH
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = init_gpt2(gen, cfg)
        n_params = count_params(params)
        toks = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen,
                             device="cuda")
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "targets": toks[:, 1:].contiguous()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs = [ray.put(params), ray.put(batch)]
        put_s = time.perf_counter() - t0
        trainer = reader
        out = ray.get(trainer.train.remote(refs, CLUSTER_GPT2_STEPS),
                      timeout=600)
        seen_pids.add(out["pid"])
        del refs
        launches = out["launches"]
        L = cfg.n_layer
        want = {"flash_fwd": 2 * L * CLUSTER_GPT2_STEPS,
                "flash_dq": L * CLUSTER_GPT2_STEPS,
                "flash_dkv": L * CLUSTER_GPT2_STEPS, "paged_attention": 0}
        if {k: launches[k] for k in want} != want:
            fail(f"cluster_gpt2: the actor's launches {launches}, want "
                 f"{want}")
        if out["params_on"] != ["cuda"]:
            fail(f"cluster_gpt2: params arrived on {out['params_on']}")
        if not all(math.isfinite(x) for x in out["losses"]):
            fail(f"cluster_gpt2: non-finite losses {out['losses']}")
        # the same steps in this process, from the same params and batch
        tx = adamw(3e-4, weight_decay=0.1)
        state = TrainState.create(params, tx)
        step = make_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx)
        direct = []
        for _ in range(CLUSTER_GPT2_STEPS):
            state, m = step(state, batch)
            direct.append(m["loss"])
        direct = [float(x) for x in direct]
        del state, step, params, batch, toks
        release(torch)
        if out["losses"] != direct:
            fail(f"cluster_gpt2: the actor's losses {out['losses']} differ "
                 f"from the driver's {direct}")
        emit({"phase": "cluster_gpt2", "card": card, "model": "gpt2-small",
              "n_params": n_params, "batch": B, "seq": T,
              "steps": CLUSTER_GPT2_STEPS, "params_put_s": put_s,
              "params_get_s_in_actor": out["get_s"],
              "losses": out["losses"], "losses_bitwise_equal_to_driver": True,
              "step_ms": spread(out["step_ms"]),
              "train_phase_step_ms": train_keep.get("step_ms"),
              "launches": launches,
              "launches_per_step": {k: v / CLUSTER_GPT2_STEPS
                                    for k, v in want.items()}})

        # -- a fault on the card
        p = trainer
        before = ray.get(p.info.remote(), timeout=CLUSTER_WAIT_S)
        try:
            ray.get(p.crash.remote(), timeout=CLUSTER_WAIT_S)
        except Exception:  # noqa: BLE001
            pass  # the call dies with its worker
        after = None
        deadline = time.monotonic() + CLUSTER_WAIT_S
        while time.monotonic() < deadline:
            try:
                after = ray.get(p.info.remote(), timeout=10)
                break
            except Exception:  # noqa: BLE001
                time.sleep(0.5)
        if after is None or after["pid"] == before["pid"] or \
                after["device_count"] != 1:
            fail(f"cluster: the restarted actor is {after} (was {before})")
        seen_pids.update((before["pid"], after["pid"]))
        marker = os.path.join(tempfile.gettempdir(),
                              f"cluster_retry_{os.getpid()}")

        @ray.remote(num_gpus=0, max_retries=2)
        def crash_once(path):
            import os

            if not os.path.exists(path):
                open(path, "w").close()
                os._exit(1)
            os.unlink(path)
            return "retried"

        retried = ray.get(crash_once.remote(marker), timeout=CLUSTER_WAIT_S)
        if retried != "retried":
            fail(f"cluster: the retried task returned {retried!r}")
        ray.kill(p)
        gpu_after = _wait_gpu_available(ray, 1.0)
        if gpu_after != 1.0:
            fail(f"cluster: GPU available {gpu_after} after the faults")
        seen_pids.update(_worker_pids(rt))
    finally:
        ray.shutdown()
    alive = []
    for pid in seen_pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    if alive:
        fail(f"cluster: worker processes {alive} outlived shutdown()")
    if os.path.exists(os.path.join(object_store._SHM_DIR, store_name)):
        fail(f"cluster: store segment {store_name} outlived shutdown()")
    emit({"phase": "cluster_fault", "card": card,
          "restarted_actor": {"before": before, "after": after},
          "retried_task": retried, "gpu_available_after": gpu_after,
          "worker_pids_checked": len(seen_pids),
          "phase_s": time.perf_counter() - t_phase})
    return launches


# ------------------------------------------------------------ phase 15


def _trainer_loop(config):
    """Phase 15's train loop: JAX's `_gpt2_loop` (tests/test_train_lib.py)
    at GPT-2-small, in a TorchTrainer worker's process. The mesh phase's
    model, batch and optimizer (`_mesh_model`) on a ``data`` mesh over
    the gang at ZeRO stage 0; resumes from `train.get_checkpoint()`;
    a `save_train_state` checkpoint every ``config["ckpt_every"]`` steps
    and at the last, which rank 0 reports; a report every step with the
    loss, the step's ms (CUDA events), this process's K1/K2/K3 launches
    in the step, its pid, card, peak memory and the wall clock. At
    ``config["crash_at"]`` on a first try, rank 0 waits for the driver
    to drain its reports, writes the wall clock to ``crashed_at`` in the
    trial dir and exits its process. (`fail` is not called here.)"""
    import torch
    import torch.distributed as dist

    import ray_tpu_torch.train as train
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.train import checkpointing
    from ray_tpu_torch.train import session as S
    from ray_tpu_torch.train.spmd import optimizer_state_bytes

    loop_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = train.get_context()
    _, init_fn, loss_fn, rules, batch = _mesh_model(torch, "gpt2")
    mesh = build_mesh(MeshSpec(data=-1))
    tx = train.adamw(3e-4, weight_decay=0.1)
    state = train.init_sharded_state(init_fn, tx, mesh, rules)
    step_fn = train.make_train_step(loss_fn, tx, mesh=mesh, rules=rules,
                                    zero_stage=0)
    state_bytes = optimizer_state_bytes(state.params) + \
        optimizer_state_bytes(state.opt_state)
    ck = train.get_checkpoint()
    start, load_s = 0, None
    if ck is not None:
        t0 = time.perf_counter()
        state = checkpointing.load_train_state(ck.path, state)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        start = int(state.step)
    torch.cuda.synchronize()
    ready = time.time()
    counters = _reset_counters()
    for step in range(start, config["steps"]):
        if config.get("crash_at") == step and ck is None and \
                ctx.get_world_rank() == 0:
            deadline = time.monotonic() + 30
            while not S.get_session().results.empty() and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            time.sleep(0.5)  # pop->register window
            with open(os.path.join(ctx.get_trial_dir(), "crashed_at"),
                      "w") as f:
                f.write(repr(time.time()))
            os._exit(1)
        before = {k: c.count for k, c in counters.items()}
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        state, m = step_fn(state, batch)
        end_ev.record()
        end_ev.synchronize()
        row = {"step": step, "loss": float(m["loss"]),
               "ms": start_ev.elapsed_time(end_ev),
               "launches": {k: c.count - before[k]
                            for k, c in counters.items()},
               "pid": os.getpid(), "card": torch.cuda.get_device_name(0),
               "backend": dist.get_backend(), "wall": time.time(),
               "peak": torch.cuda.max_memory_allocated(),
               "bytes": state_bytes, "load_s": load_s, "save_s": None,
               "process_start": _process_start(), "loop_start": loop_start,
               "ready": ready}
        load_s = None
        ckpt = None
        if (step + 1) % config["ckpt_every"] == 0 or \
                step == config["steps"] - 1:
            # collective save: every rank calls in; rank 0 reports
            t0 = time.perf_counter()
            tmp = os.path.join(ctx.get_trial_dir(), f"pending_ckpt_{step}")
            checkpointing.save_train_state(state, tmp)
            row["save_s"] = time.perf_counter() - t0
            if ctx.get_world_rank() == 0:
                ckpt = train.Checkpoint(tmp)
        train.report(row, checkpoint=ckpt)


def _process_start() -> float:
    """This process's start on the wall clock (Linux: its start in clock
    ticks after boot, from /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


class _TrialRows:
    """`_tune_trial`'s record across processes: each process appends its
    rows as JSON lines to a file of its own under `path`."""

    def __init__(self, path: str):
        self.path = path

    def append(self, row: dict) -> None:
        os.makedirs(self.path, exist_ok=True)
        with open(os.path.join(self.path, f"{os.getpid()}.jsonl"),
                  "a") as f:
            f.write(json.dumps(row) + "\n")

    def read(self) -> list[dict]:
        rows = []
        for name in sorted(os.listdir(self.path)):
            with open(os.path.join(self.path, name)) as f:
                rows += [json.loads(line) for line in f]
        return rows


def _overlap_share(r: dict, rows: list[dict]) -> float:
    """The share of step `r`'s wall-clock interval that steps of other
    processes among `rows` cover."""
    others = sorted((o["start"], o["end"]) for o in rows
                    if o["pid"] != r["pid"] and o["end"] > r["start"]
                    and o["start"] < r["end"])
    covered, at = 0.0, r["start"]
    for start, end in others:
        start, end = max(start, at), min(end, r["end"])
        if end > start:
            covered += end - start
            at = end
    return covered / (r["end"] - r["start"])


def _cluster_trial(config):
    """Phase 12's trial (`_tune_trial`) in a trial actor's process, its
    rows kept in files under ``config["rows"]``; the launch counters are
    zeroed just before the trial's run."""
    import torch

    _reset_counters()
    _tune_trial(torch, _TrialRows(config["rows"]), None, config)


def _trainer_runs(torch, card: str, mesh_ref: dict) -> tuple[dict, dict]:
    """trainer_gpt2: runs A and B (see phase_trainer_tune); returns its
    row and the launches of both runs."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.train import (
        CheckpointConfig,
        FailureConfig,
        RunConfig,
        ScalingConfig,
        TorchTrainer,
    )

    out = {}
    for run, crash, failures in (("A", None, 0), ("B", TRAINER_CRASH_AT, 1)):
        t0 = time.perf_counter()
        try:
            result = TorchTrainer(
                _trainer_loop,
                train_loop_config={"steps": TRAINER_STEPS,
                                   "ckpt_every": TRAINER_CKPT_EVERY,
                                   "crash_at": crash},
                scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                run_config=RunConfig(
                    name=f"run_{run}", storage_path=TRAINER_DIR,
                    failure_config=FailureConfig(max_failures=failures),
                    checkpoint_config=CheckpointConfig(num_to_keep=2)),
            ).fit()
        except Exception as e:  # noqa: BLE001
            fail(f"trainer_gpt2: run {run} failed: {e}")
        out[run] = {"history": result.metrics_history,
                    "fit_s": time.perf_counter() - t0,
                    "checkpoint": result.checkpoint}
    a, b = out["A"]["history"], out["B"]["history"]
    for run in out:  # num_to_keep=2 pruned the older checkpoints
        kept = sorted(n for n in os.listdir(os.path.join(TRAINER_DIR,
                                                         f"run_{run}"))
                      if n.startswith("checkpoint_"))
        if len(kept) != 2 or int(kept[-1].split("_")[1]) < 2:
            fail(f"trainer_gpt2: run {run} kept the checkpoints {kept}, "
                 f"want the last 2 of at least 3")
    crash_file = os.path.join(TRAINER_DIR, "run_B", "crashed_at")
    if not os.path.exists(crash_file):
        fail("trainer_gpt2: run B's rank 0 never crashed")
    with open(crash_file) as f:
        crashed_at = float(f.read())
    L = GPT2Config.small().n_layer
    per_step = {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
                "paged_attention": 0}
    for r in a + b:
        if r["launches"] != per_step:
            fail(f"trainer_gpt2: step {r['step']} in pid {r['pid']} "
                 f"launched {r['launches']}, want {per_step}")
        if not math.isfinite(r["loss"]):
            fail(f"trainer_gpt2: non-finite loss at step {r['step']}")
        if r["card"] != torch.cuda.get_device_name(0) or \
                r["backend"] != "nccl":
            fail(f"trainer_gpt2: a worker ran on {r['card']} over "
                 f"{r['backend']}, not {torch.cuda.get_device_name(0)} "
                 f"over nccl")
    want_a = list(range(TRAINER_STEPS))
    before = [r for r in b if r["wall"] < crashed_at]
    after = [r for r in b if r["wall"] >= crashed_at]
    resume_at = (TRAINER_CRASH_AT // TRAINER_CKPT_EVERY) * TRAINER_CKPT_EVERY
    if [r["step"] for r in a] != want_a or \
            [r["step"] for r in before] != list(range(TRAINER_CRASH_AT)) or \
            [r["step"] for r in after] != list(range(resume_at,
                                                     TRAINER_STEPS)):
        fail(f"trainer_gpt2: steps A {[r['step'] for r in a]}, B "
             f"{[r['step'] for r in b]} (crash at {TRAINER_CRASH_AT}, "
             f"resume at {resume_at})")
    pids_b = [{r["pid"] for r in before}, {r["pid"] for r in after}]
    if any(len(p) != 1 for p in pids_b) or pids_b[0] == pids_b[1]:
        fail(f"trainer_gpt2: run B's pids before and after the restart "
             f"{pids_b}: want one each, distinct")
    loss_a = {r["step"]: r["loss"] for r in a}
    unequal = [(r["step"], r["loss"], loss_a[r["step"]]) for r in b
               if r["loss"] != loss_a[r["step"]]]
    if unequal:
        fail(f"trainer_gpt2: run B's losses differ from run A's "
             f"(step, B, A): {unequal}")
    row = {"phase": "trainer_gpt2", "card": card, "model": "gpt2-small",
           "batch": TRAIN_BATCH, "workers": 1, "backend": "nccl",
           "steps": TRAINER_STEPS, "ckpt_every": TRAINER_CKPT_EVERY,
           "crash_at": TRAINER_CRASH_AT, "resumed_at": resume_at,
           "losses_a": [r["loss"] for r in a],
           "losses_b_after_restart": [r["loss"] for r in after],
           "losses_b_bitwise_equal_to_a": True,
           "pids_a": sorted({r["pid"] for r in a}),
           "pids_b": [sorted(p) for p in pids_b],
           "fit_s": {k: v["fit_s"] for k, v in out.items()},
           "launches_per_step": per_step}
    if mesh_ref.get("losses"):
        worst = max(abs(x - y) / abs(y) for x, y in
                    zip(row["losses_a"], mesh_ref["losses"]))
        if worst > MESH_RTOL:
            fail(f"trainer_gpt2: run A's losses {row['losses_a']} against "
                 f"the mesh phase's {mesh_ref['losses']} (rtol "
                 f"{MESH_RTOL})")
        row["max_rel_diff_from_mesh_phase"] = worst
    else:
        row["max_rel_diff_from_mesh_phase"] = "mesh phase not run"
    steady = [r["ms"] for r in a[1:]]
    saves = [r["save_s"] for r in a + b if r["save_s"]]
    gb = a[0]["bytes"] / 1e9
    row.update({
        "step_ms": spread(steady), "first_step_ms": a[0]["ms"],
        "mesh_phase_step_ms": mesh_ref.get("step_ms", "mesh phase not run"),
        "step_ms_note": "CUDA events around each step in the worker; "
                        "the first step left out",
        "restart_s": after[0]["wall"] - crashed_at,
        "restart_note": "the crash's wall clock to the first report of "
                        "the new gang (its spawn, rendezvous, init, "
                        "checkpoint load and one step)",
        "restart_split_s": _gang_split(after[0], crashed_at),
        "first_start_split_s": _gang_split(a[0], None),
        "load_s": after[0]["load_s"],
        "checkpoint_gb": gb, "saves": len(saves), "save_s": spread(saves),
        "save_gb_per_s": gb / float(np.median(saves)),
        "load_gb_per_s": gb / after[0]["load_s"],
        "peak_bytes_by_pid": {str(p): max(r["peak"] for r in a + b
                                          if r["pid"] == p)
                              for p in {r["pid"] for r in a + b}}})
    emit(row)
    launches = {k: v * len(a + b) for k, v in per_step.items()}
    return row, launches


def _gang_split(first: dict, since: float | None) -> dict:
    """Where a gang's start went, from its first report: `since` (the
    crash) to its worker's process start (the death seen, the old group
    torn down, a placement group, a spawn), then to the loop's entry
    (torch's import, the CUDA context, the rendezvous), to the state
    ready (init, the mesh, a checkpoint's load), to the first report
    (the first step and its save)."""
    out = {"to_loop": first["loop_start"] - first["process_start"],
           "to_ready": first["ready"] - first["loop_start"],
           "to_first_report": first["wall"] - first["ready"]}
    if since is not None:
        out = {"to_process_start": first["process_start"] - since, **out}
    return out


def _tune_cluster(torch, card: str, tune_ref: dict) -> tuple[dict, dict]:
    """tune_cluster: phase 12's sweep and restore with each trial in a
    worker process of its own (see phase_trainer_tune)."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.train import RunConfig

    def trials(run: str, lrs, ckpt_at, **tune_kw):
        return tune.Tuner(
            _cluster_trial,
            param_space={"lr": tune.grid_search(list(lrs)), "run": run,
                         "steps": TUNE_MAX_T, "ckpt_at": ckpt_at,
                         "rows": os.path.join(TUNE_DIR, "rows", run)},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min",
                trial_resources=TUNE_CLUSTER_RES, **tune_kw),
            run_config=RunConfig(name=run, storage_path=TUNE_DIR))

    t0 = time.perf_counter()
    sweep_grid = trials(
        "cluster_sweep", TUNE_CLUSTER_LRS,
        list(range(TUNE_CKPT_EVERY, TUNE_MAX_T + 1, TUNE_CKPT_EVERY)),
        max_concurrent_trials=TUNE_CONCURRENT,
        scheduler=tune.ASHAScheduler(max_t=TUNE_MAX_T,
                                     grace_period=TUNE_GRACE,
                                     reduction_factor=TUNE_RF)).fit()
    sweep_s = time.perf_counter() - t0
    status = _trial_status(os.path.join(TUNE_DIR, "cluster_sweep"))
    first_grid = trials("cluster_resume", [TUNE_RESUME_LR],
                        [TUNE_CKPT_EVERY]).fit()
    exp = os.path.join(TUNE_DIR, "cluster_resume")
    resume_rows = _TrialRows(os.path.join(TUNE_DIR, "rows",
                                          "cluster_resume"))
    n_first = len(resume_rows.read())
    with open(os.path.join(exp, "tuner_state.json")) as f:
        state = json.load(f)
    state["trials"][0]["status"] = "RUNNING"  # as if it died at the end
    with open(os.path.join(exp, "tuner_state.json"), "w") as f:
        json.dump(state, f)
    restored = tune.Tuner.restore(exp, _cluster_trial)
    restored.tune_config = tune.TuneConfig(
        metric="loss", mode="min", trial_resources=TUNE_CLUSTER_RES)
    restored_grid = restored.fit()

    for what, g in (("sweep", sweep_grid), ("resume", first_grid),
                    ("restore", restored_grid)):
        if g.errors:
            fail(f"tune_cluster: a {what} trial failed: {g.errors[0].error}")
    sweep = _TrialRows(os.path.join(TUNE_DIR, "rows",
                                    "cluster_sweep")).read()
    resume = resume_rows.read()
    rows = sweep + resume
    if not all(math.isfinite(r["loss"]) for r in rows):
        fail(f"tune_cluster: non-finite losses {[r['loss'] for r in rows]}")
    if not all(r["on_cuda"] for r in rows):
        fail("tune_cluster: a trial's params left the card")
    # a step ran "at once" when other trial processes' steps cover at
    # least half of its wall-clock interval
    for r in sweep:
        r["overlap"] = _overlap_share(r, sweep)
    two = [r for r in sweep if r["overlap"] >= 0.5]
    if len({r["pid"] for r in two}) < TUNE_CONCURRENT:
        fail(f"tune_cluster: no {TUNE_CONCURRENT} trial processes trained "
             f"at once (pids of the steps that overlap another "
             f"process's: {sorted({r['pid'] for r in two})})")
    if os.getpid() in {r["pid"] for r in rows}:
        fail("tune_cluster: a trial ran in the driver's process")
    # the trial beyond TUNE_CONCURRENT waited for a slot, then started in
    # a process of its own
    spans = {}
    for r in sweep:
        lo, hi = spans.get(r["pid"], (r["start"], r["end"]))
        spans[r["pid"]] = (min(lo, r["start"]), max(hi, r["end"]))
    order = sorted(spans.values())
    if len(spans) != len(TUNE_CLUSTER_LRS) or \
            order[-1][0] < min(hi for _, hi in order[:TUNE_CONCURRENT]):
        fail(f"tune_cluster: the sweep's trial processes ran over "
             f"{order}: want {len(TUNE_CLUSTER_LRS)}, the last started "
             f"after one of the first {TUNE_CONCURRENT} ended")
    L = GPT2Config.small().n_layer
    per_step = {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L}
    by_pid: dict[int, list] = {}
    by_run: dict[tuple, list] = {}
    for r in rows:
        by_pid.setdefault(r["pid"], []).append(r)
        by_run.setdefault((r["pid"], r["lr"], r["resumed"]), []).append(r)
    launches = {k: 0 for k in per_step}
    for (pid, lr, _), prows in by_run.items():
        want = {k: v * len(prows) for k, v in per_step.items()}
        if prows[-1]["launches"] != want:
            fail(f"tune_cluster: trial lr={lr} in process {pid} launched "
                 f"{prows[-1]['launches']} in {len(prows)} steps, want "
                 f"{want}")
        for k in launches:
            launches[k] += want[k]
    again = resume[n_first:]
    before = {r["step"]: r["loss"] for r in resume[:n_first]}
    if [r["step"] for r in again] != list(
            range(TUNE_CKPT_EVERY + 1, TUNE_MAX_T + 1)) or \
            not all(r["resumed"] for r in again):
        fail(f"tune_cluster: the restored trial ran steps "
             f"{[r['step'] for r in again]}, want "
             f"{TUNE_CKPT_EVERY + 1}-{TUNE_MAX_T} from its checkpoint")
    if {r["pid"] for r in again} & {r["pid"] for r in resume[:n_first]}:
        fail("tune_cluster: the restored trial ran in its first process")
    unequal = [(r["step"], r["loss"], before[r["step"]]) for r in again
               if r["loss"] != before[r["step"]]]
    if unequal:
        fail(f"tune_cluster: restored losses differ from the first run's "
             f"(step, restored, first): {unequal}")
    two_ms = [r["ms"] for r in two if r["step"] > 1]
    alone = [r["ms"] for r in resume[:n_first] if r["step"] > 1]
    row = {"phase": "tune_cluster", "card": card, "model": "gpt2-small",
           "batch": TRAIN_BATCH, "lrs": TUNE_CLUSTER_LRS,
           "trial_resources": TUNE_CLUSTER_RES,
           "concurrent": TUNE_CONCURRENT, "sweep_s": sweep_s,
           "trials": {str(lr): {"steps": max(r["step"] for r in sweep
                                             if r["lr"] == lr),
                                "asha": status[lr]}
                      for lr in TUNE_CLUSTER_LRS},
           "trial_pids": sorted(by_pid),
           "resume_losses": [r["loss"] for r in again],
           "resume_losses_bitwise_equal": True,
           "step_ms_two_processes_at_once": (spread(two_ms) if two_ms
                                             else "none ran at once"),
           "steps_at_once": len(two_ms),
           "steps_at_once_note": "sweep steps (the first of each trial "
                                 "left out) whose wall-clock interval other "
                                 "trial processes' steps cover for at "
                                 "least half its length",
           "overlap_by_step": [(r["lr"], r["step"], round(r["overlap"], 3))
                               for r in sweep],
           "step_ms_alone": spread(alone),
           "phase12_two_threads_at_once": tune_ref.get(
               "two_at_once", "phase 12 not run"),
           "phase12_alone": tune_ref.get("alone", "phase 12 not run"),
           "step_ms_note": "host clock around one step and the loss's read",
           "peak_bytes_by_pid": {str(p): max(r["peak"] for r in prows)
                                 for p, prows in by_pid.items()},
           "launches": launches, "launches_per_step": per_step}
    emit(row)
    return row, {**launches, "paged_attention": 0}


def phase_trainer_tune(torch, card: str, keep: dict) -> dict:
    """Phase 15: Train and Tune on the cluster runtime, on its own
    ``init()`` after the driver's CUDA cache is emptied (see the
    docstring); returns the launches of the paths trainer_gpt2 and
    tune_cluster. `keep` may hold the mesh phase's GPT-2 losses and step
    ms (``keep["mesh"]``) and phase 12's step ms (``keep["tune"]``)."""
    import shutil

    import ray_tpu_torch as ray
    from ray_tpu_torch.core import object_store
    from ray_tpu_torch.core.api import _global_runtime

    t_phase = time.perf_counter()
    release(torch)
    for d in (TRAINER_DIR, TUNE_DIR):
        shutil.rmtree(d, ignore_errors=True)
    ray.init()
    rt = _global_runtime()
    store_name = rt.store.name
    seen_pids: set = set()
    try:
        trainer_row, trainer_launches = _trainer_runs(
            torch, card, keep.get("mesh", {}))
        tune_row, tune_launches = _tune_cluster(torch, card,
                                                keep.get("tune", {}))
        seen_pids.update(_worker_pids(rt))
    finally:
        ray.shutdown()
        for d in (TRAINER_DIR, TUNE_DIR):
            shutil.rmtree(d, ignore_errors=True)
    seen_pids.update(trainer_row["pids_a"], *trainer_row["pids_b"],
                     tune_row["trial_pids"])
    alive = []
    for pid in seen_pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    if alive:
        fail(f"trainer_tune: worker processes {alive} outlived shutdown()")
    if os.path.exists(os.path.join(object_store._SHM_DIR, store_name)):
        fail(f"trainer_tune: store segment {store_name} outlived "
             f"shutdown()")
    emit({"phase": "trainer_tune_shutdown", "card": card,
          "worker_pids_checked": len(seen_pids),
          "phase_s": time.perf_counter() - t_phase})
    return {"trainer_gpt2": trainer_launches, "tune_cluster": tune_launches}


# ------------------------------------------------------------ phase 16


def _hop_source(kind: str, v: int, mb: int, V: int):
    """The op whose output an op takes (None: its input is the
    driver's)."""
    if kind == "fwd":
        return ("fwd", v - 1, mb) if v > 0 else None
    return ("bwd", v + 1, mb) if v < V - 1 else None


def _schedule_faults(stage_stats: list[dict], S: int, R: int,
                     M: int) -> list[str]:
    """What in one step's op spans breaks the schedule (empty: nothing):
    a stage whose ops did not run in its submission order, two ops of a
    stage that overlap (their host copies included), an op that started
    before its input's producer had copied that input to the host. A
    span is `(kind, v, mb, t0, t1, h2d_s, d2h_s)`: the compute alone on
    the host's monotonic clock, which the processes share."""
    from ray_tpu_torch.parallel.pipeline import (
        interleaved_1f1b_submission_order,
        one_f_one_b_submission_order,
    )

    order = (interleaved_1f1b_submission_order(S, M, R) if R > 1
             else one_f_one_b_submission_order(S, M))
    faults, ops = [], {}
    for st in stage_stats:
        spans = sorted(st["op_spans"], key=lambda o: o[3])
        got = [tuple(o[:3]) for o in spans]
        want = [op for op in order if op[1] % S == st["stage"]]
        if got != want:
            faults.append(f"stage {st['stage']} ran {got}, submitted {want}")
        for a, b in zip(spans, spans[1:]):
            if a[4] + a[6] > b[3] - b[5] + 1e-6:
                faults.append(f"stage {st['stage']}: {a[:3]} overlaps "
                              f"{b[:3]}")
        ops.update((tuple(o[:3]), o) for o in spans)
    for key, o in ops.items():
        src = _hop_source(*key, S * R)
        if src is not None and src in ops and \
                o[3] < ops[src][4] + ops[src][6] - 1e-6:
            faults.append(f"{key} started before {src}'s output reached "
                          f"the host")
    return faults


def _hops(stage_stats: list[dict], S: int, R: int, M: int) -> dict:
    """The activations and cotangents of one step that crossed stages,
    from each stage's op spans (see `_schedule_faults`). A hop runs from
    its producer's compute end to its consumer's compute start: the
    producer's device-to-host copy, the put, the dispatch, the
    consumer's get and its host-to-device copy. `stalled_s` is what the
    consumer waited for each hop once it was free (its start less the
    later of the producer's end and the end of its own previous op's
    copy out); `latency_s` is the whole gap of the hops whose consumer
    sat idle at the producer's end, split into `d2h_s`, `h2d_s` and
    `store_s` (the rest: the put, the dispatch, the get)."""
    V = S * R
    ops, free_at = {}, {}
    for st in stage_stats:
        spans = sorted(st["op_spans"], key=lambda o: o[3])
        for i, o in enumerate(spans):
            ops[tuple(o[:3])] = o
            prev = spans[i - 1] if i else None
            free_at[tuple(o[:3])] = prev[4] + prev[6] if prev else None
    stalled, latency, d2h, h2d, store = [], [], [], [], []
    for key, o in ops.items():
        src = _hop_source(*key, V)
        if src is None or key[1] % S == src[1] % S:
            continue  # an input from the driver, or the same process
        produced = ops[src][4]
        free = free_at[key]
        stalled.append(o[3] - max(produced, free or produced))
        if free is None or free <= produced:
            latency.append(o[3] - produced)
            d2h.append(ops[src][6])
            h2d.append(o[5])
            store.append(latency[-1] - d2h[-1] - h2d[-1])

    def median(xs):
        return float(np.median(xs)) if xs else None

    return {"hops": len(stalled), "stalled_s_sum": float(sum(stalled)),
            "stalled_s_median": median(stalled),
            "idle_consumer_hops": len(latency),
            "latency_s_median": median(latency),
            "latency_s_max": float(max(latency)) if latency else None,
            "d2h_s_median": median(d2h), "h2d_s_median": median(h2d),
            "store_s_median": median(store)}


def phase_pipeline_gpt2(torch, card: str, keep: dict) -> dict:
    """Phase 16: the MPMD pipeline strategy (``train.pipeline_strategy``)
    on a fresh ``init()`` (see the docstring); `keep` holds phase 9's
    batch, losses and step ms. Returns the launches of K1-K4 in the
    stage processes (the path pipeline_gpt2)."""
    import shutil

    import ray_tpu_torch as ray
    from ray_tpu_torch.core import object_store
    from ray_tpu_torch.core.api import _global_runtime
    from ray_tpu_torch.parallel.pipeline import (
        theoretical_bubble,
        theoretical_bubble_interleaved,
    )
    from ray_tpu_torch.train import (
        CheckpointConfig,
        RunConfig,
        ScalingConfig,
        TorchTrainer,
    )
    from ray_tpu_torch.train import pipeline_strategy as P
    from ray_tpu_torch.util import tree

    t_phase = time.perf_counter()
    if not keep.get("losses"):
        fail("pipeline_gpt2: phase 9 (pipelined) made no reference")
    release(torch)
    shutil.rmtree(PIPELINE_DIR, ignore_errors=True)
    toks = keep["tokens"]
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    S, M = PIPELINE_STAGES, PIPELINED_CFG["num_microbatches"]
    counters = _reset_counters()
    os.environ["RAY_TPU_OBJECT_STORE_BYTES"] = str(CLUSTER_STORE_BYTES)
    try:
        ray.init()
    finally:
        os.environ.pop("RAY_TPU_OBJECT_STORE_BYTES", None)
    rt = _global_runtime()
    store_name = rt.store.name
    seen_pids: set = set()
    runs = {}
    try:
        t0 = time.perf_counter()
        try:
            result = TorchTrainer(
                strategy="pipeline",
                train_loop_config={
                    "model": PIPELINED_CFG, "batch": batch,
                    "steps": PIPELINE_A_STEPS, "num_stages": S,
                    "num_microbatches": M, "lr": 1e-2, "seed": 13},
                scaling_config=ScalingConfig(
                    num_workers=S, use_gpu=True,
                    resources_per_worker=PIPELINE_STAGE_RES),
                run_config=RunConfig(
                    name="run_A", storage_path=PIPELINE_DIR,
                    checkpoint_config=CheckpointConfig(
                        num_to_keep=1,
                        checkpoint_frequency=PIPELINE_A_STEPS)),
            ).fit()
        except Exception as e:  # noqa: BLE001
            fail(f"pipeline_gpt2: run A failed: {e}")
        runs["A"] = {"history": result.metrics_history,
                     "stage_stats": result.stage_stats,
                     "fit_s": time.perf_counter() - t0}
        t1 = time.perf_counter()
        a_params, a_meta = P.load_pipeline_checkpoint(
            result.checkpoint.path)
        load_s = time.perf_counter() - t1
        t0 = time.perf_counter()
        try:
            ps = P.PipelineStrategy(
                PIPELINED_CFG, num_stages=S, num_microbatches=M, lr=1e-2,
                seed=13, resources_per_worker=PIPELINE_STAGE_RES,
                num_repeats=PIPELINE_B_REPEATS, device="cuda")
            try:
                hist = [ps.train_step(batch)
                        for _ in range(PIPELINE_B_STEPS)]
                fit_s = time.perf_counter() - t0
                b_ck = ps.save_checkpoint(os.path.join(PIPELINE_DIR,
                                                       "run_B"))
                b_final = ps.full_params()
            finally:
                ps.shutdown()
        except Exception as e:  # noqa: BLE001
            fail(f"pipeline_gpt2: run B failed: {e}")
        runs["B"] = {"history": hist, "stage_stats": ps.last_stage_stats,
                     "fit_s": fit_s}
        b_params, b_meta = P.load_pipeline_checkpoint(b_ck.path)
        seen_pids.update(_worker_pids(rt))
    finally:
        ray.shutdown()
        shutil.rmtree(PIPELINE_DIR, ignore_errors=True)

    hop_bytes = (PIPELINED_BATCH // M) * PIPELINED_CFG["block_size"] * \
        PIPELINED_CFG["d_model"] * 4
    row = {"phase": "pipeline_gpt2", "card": card, "config": PIPELINED_CFG,
           "batch": PIPELINED_BATCH, "microbatches": M, "stages": S,
           "stage_resources": PIPELINE_STAGE_RES, "dtype": "float32",
           "optimizer": "sgd(1e-2)",
           "phase9_losses": keep["losses"],
           "phase9_step_ms": keep["step_ms"],
           "checkpoint_load_s": load_s}
    launches = {k: 0 for k in ("flash_fwd", "flash_dq", "flash_dkv",
                               "paged_attention")}
    for name, R, want_bubble in (
            ("A", 1, theoretical_bubble(S, M)),
            ("B", PIPELINE_B_REPEATS,
             theoretical_bubble_interleaved(S, M, PIPELINE_B_REPEATS))):
        run = runs[name]
        hist = run["history"]
        stats = run["stage_stats"]
        losses = [h["loss"] for h in hist]
        rel = [abs(x - y) / abs(y) for x, y in zip(losses, keep["losses"])]
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            fail(f"pipeline_gpt2: run {name}'s losses {losses} do not fall")
        if len(rel) < 2 or max(rel) > PIPELINED_RTOL:
            fail(f"pipeline_gpt2: run {name}'s losses {losses[:2]} against "
                 f"phase 9's {keep['losses']} (rtol {PIPELINED_RTOL})")
        for h in hist:
            if not 0.0 <= h["bubble_ratio"] < 1.0:
                fail(f"pipeline_gpt2: run {name}'s bubble "
                     f"{h['bubble_ratio']} is outside [0, 1)")
            if h["bubble_theoretical"] != want_bubble:
                fail(f"pipeline_gpt2: run {name}'s theoretical bubble "
                     f"{h['bubble_theoretical']}, want {want_bubble}")
        # the last step's bubble from its spans: on the card a stage's
        # busy time is the sum of its ops' compute spans, copies outside
        faults = _schedule_faults(stats, S, R, M)
        if faults:
            fail(f"pipeline_gpt2: run {name}'s last step broke the "
                 f"schedule: {faults[:4]}")
        busy = sum(sum(o[4] - o[3] for o in st["op_spans"]) for st in stats)
        makespan = max(max(o[4] for o in st["op_spans"])
                       - min(o[3] for o in st["op_spans"]) for st in stats)
        from_spans = 1.0 - busy / (S * makespan)
        if abs(from_spans - hist[-1]["bubble_ratio"]) > 1e-9:
            fail(f"pipeline_gpt2: run {name}'s last bubble "
                 f"{hist[-1]['bubble_ratio']}, {from_spans} from its spans")
        for st in stats:
            if st["pid"] == os.getpid():
                fail(f"pipeline_gpt2: run {name}'s stage {st['stage']} ran "
                     f"in the driver's process")
            if st["device_name"] != torch.cuda.get_device_name(0):
                fail(f"pipeline_gpt2: run {name}'s stage {st['stage']} ran "
                     f"on {st['device']} ({st['device_name']})")
            if any(st["launches"].values()):
                fail(f"pipeline_gpt2: run {name}'s stage {st['stage']} "
                     f"launched {st['launches']}: the pipelined model's "
                     f"attention is the plain einsum")
            for k in launches:
                launches[k] += st["launches"][k]
        seen_pids.update(st["pid"] for st in stats)
        V = S * R
        steady = [h["step_seconds"] for h in hist[1:]]
        row[f"run_{name}"] = {
            "entry": ("TorchTrainer(strategy='pipeline')" if name == "A"
                      else "PipelineStrategy"),
            "num_repeats": R, "virtual_stages": V, "losses": losses,
            "max_rel_diff_from_phase9": max(rel[:2]),
            "step_s": [h["step_seconds"] for h in hist],
            "step_s_after_first": spread(steady),
            "bubble": [h["bubble_ratio"] for h in hist],
            "bubble_theoretical": want_bubble,
            "last_step_stages": [
                {k: st[k] for k in ("stage", "busy_s", "busy_wall_s",
                                    "copy_s", "window_s", "ops")}
                for st in stats],
            "bytes_across_stages_a_step": 2 * (V - 1) * M * hop_bytes,
            "hop_bytes": hop_bytes, "last_step_hops": _hops(stats, S, R, M),
            "pids": [st["pid"] for st in stats],
            "peak_bytes_by_stage": [st["peak_bytes"] for st in stats],
            "fit_s": run["fit_s"]}
    # run B's checkpoint read back equals its live params bit for bit;
    # run A's (the trainer's, written at its last step) has their tree
    for ck_name, got, want in (("B", b_params, b_final),
                               ("A", a_params, b_final)):
        got = list(tree.leaves_with_path(got))
        want = list(tree.leaves_with_path(want))
        if len(got) != len(want) or not all(
                pg == pw and g.shape == w.shape and g.dtype == w.dtype
                and bool(torch.isfinite(g).all())
                for (pg, g), (pw, w) in zip(got, want)):
            fail(f"pipeline_gpt2: run {ck_name}'s checkpoint is not the "
                 f"model's param tree")
        if ck_name == "B" and not all(torch.equal(g, w) for (_, g), (_, w)
                                      in zip(got, want)):
            fail("pipeline_gpt2: run B's checkpoint differs from its final "
                 "params")
    for ck_name, meta, R in (("A", a_meta, 1), ("B", b_meta,
                                                 PIPELINE_B_REPEATS)):
        if meta.get("format") != "pipeline-stage-shards-v1" or \
                meta.get("num_stages") != S or meta.get("num_repeats") != R:
            fail(f"pipeline_gpt2: run {ck_name}'s checkpoint meta {meta}")
    row["run_B_checkpoint_bitwise_equal"] = True
    alive = []
    for pid in seen_pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    if alive:
        fail(f"pipeline_gpt2: worker processes {alive} outlived shutdown()")
    if os.path.exists(os.path.join(object_store._SHM_DIR, store_name)):
        fail(f"pipeline_gpt2: store segment {store_name} outlived "
             f"shutdown()")
    driver = {k: c.count for k, c in counters.items()}
    if any(driver.values()):
        fail(f"pipeline_gpt2: the driver launched {driver}")
    row.update({"launches_in_stage_processes": launches,
                "launches_in_driver": driver,
                "worker_pids_checked": len(seen_pids),
                "phase_s": time.perf_counter() - t_phase})
    emit(row)
    return launches


# ------------------------------------------------------------ phase 17


def _proc_start() -> float:
    """This process's start on the wall clock (from /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))


class RuntimeEnvWorker:
    """Phase 17's GPU actor, defined in this script (``__main__``, so
    pickled by value). It runs in a runtime environment (RUNTIME_ENV_VAR
    and a working_dir holding RUNTIME_MODULE) and trains GPT-2-small
    from the seed the driver uses."""

    def __init__(self):
        t0 = time.time()
        import torch

        t1 = time.time()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)  # raises when the card is hidden
        torch.ones(1, device="cuda").sum().item()
        self.start = {"proc_start": _proc_start(), "init_start": t0,
                      "torch_imported": t1, "cuda_ready": time.time()}
        self.state = self.step = self.batch = None

    def probe(self) -> dict:
        """What the runtime environment gave this process."""
        import importlib

        import torch

        mod = importlib.import_module(RUNTIME_MODULE)
        return {"pid": os.getpid(), "cwd": os.path.realpath(os.getcwd()),
                "module_value": mod.VALUE,
                "module_file": os.path.realpath(mod.__file__),
                "env_var": os.environ.get(RUNTIME_ENV_VAR[0]),
                "device_count": torch.cuda.device_count(),
                "name": torch.cuda.get_device_name(0), "start": self.start}

    def train(self, steps: int) -> dict:
        """GPT-2-small's train step (train's recipe) from seed 0's params
        and batch, `steps` steps, this process's launch counters zeroed
        just before and read just after; the state stays for `stream`."""
        import torch

        counters = _reset_counters()
        self.state, self.step, self.batch = _runtime_gpt2(torch)
        losses = []
        for _ in range(steps):
            self.state, m = self.step(self.state, self.batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        return {"pid": os.getpid(), "losses": [float(x) for x in losses],
                "launches": launch_counts(counters)}

    def stream(self, items: int, nbytes: int):
        """`items` more steps; after each, yield a `nbytes` slice of the
        largest param (a CUDA tensor) with the SHA-256 of its bytes, the
        step's end (wall clock) and the launches since the first."""
        import hashlib

        import torch

        from ray_tpu_torch.util import tree

        counters = _reset_counters()
        for _ in range(items):
            self.state, _m = self.step(self.state, self.batch)
            torch.cuda.synchronize()
            t_end = time.time()
            big = max(tree.leaves(self.state.params), key=lambda t: t.numel())
            x = big.detach().reshape(-1)[:nbytes // big.element_size()]
            x = x.clone()
            sha = hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
            yield {"x": x, "sha256": sha, "t_step_end": t_end,
                   "launches": launch_counts(counters)}


def _gpt2_train_setup(torch, params, cfg, gen):
    """train's recipe over GPT-2 `params`: adamw, the loss's train step
    and a TRAIN_BATCH batch drawn from `gen` on the card; the train
    state, step and batch."""
    from ray_tpu_torch.models.gpt2 import gpt2_loss
    from ray_tpu_torch.train import TrainState, adamw, make_train_step

    B, T = TRAIN_BATCH
    toks = torch.randint(0, cfg.vocab_size, (B, T + 1), generator=gen,
                         device="cuda")
    batch = {"tokens": toks[:, :-1].contiguous(),
             "targets": toks[:, 1:].contiguous()}
    tx = adamw(3e-4, weight_decay=0.1)
    step = make_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx)
    return TrainState.create(params, tx), step, batch


def _runtime_gpt2(torch):
    """GPT-2-small's params, train state, step and batch from seed 0 on
    the card: the driver's reference and the actor's run."""
    from ray_tpu_torch.models.gpt2 import GPT2Config, init_gpt2

    cfg = GPT2Config.small()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return _gpt2_train_setup(torch, init_gpt2(gen, cfg), cfg, gen)


def _k1_inputs(torch, seed: int):
    B, T, H, D = RUNTIME_K1_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return [torch.randn((B, T, H, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(3)]


def _k1_task(seed: int) -> tuple:
    """Phase 17 (c)'s task: K1's forward at the training shape on this
    process's card, with this process's launch counters, pid and the
    wall-clock marks of its start."""
    t0 = time.time()
    import torch

    from ray_tpu_torch.ops.flash_attention import flash_attention

    t1 = time.time()
    torch.cuda.set_device(0)  # raises when the card is hidden
    counters = _reset_counters()
    q, k, v = _k1_inputs(torch, seed)
    torch.cuda.synchronize()
    t2 = time.time()
    o = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    return o, launch_counts(counters), os.getpid(), {
        "proc_start": _proc_start(), "task_start": t0,
        "torch_imported": t1, "cuda_ready": t2, "done": time.time()}


def _start_split(start: dict, submitted: float) -> dict:
    """Seconds from a submission to a worker's process start, to its
    code's first line, to torch imported, to its first CUDA work."""
    marks = [("to_process", "proc_start"),
             ("to_code", "task_start" if "task_start" in start
              else "init_start"),
             ("torch_import", "torch_imported"),
             ("cuda_context", "cuda_ready")]
    out, prev = {}, submitted
    for name, key in marks:
        out[name] = start[key] - prev
        prev = start[key]
    return out


def _node_workers(ray, nodelets) -> dict:
    """pid -> (actor id, spawn-to-ready seconds) of every worker of the
    given nodelets."""
    from ray_tpu_torch.core.rpc import RpcClient

    client = RpcClient.shared()
    out = {}
    for nl in nodelets:
        st = client.call(nl.address, "node_stats", {}, timeout=10)
        out.update({w["pid"]: (w["actor_id"], w["ready_s"])
                    for w in st["workers"]})
    return out


def _runtime_parts(torch, ray, c, card: str, env: dict,
                   ppo_local: dict | None, seen_pids: set) -> dict:
    """Phase 17's four parts on the Cluster `c` (the head node in this
    process with the card and the 512 MiB store, node B with the card
    for (c)); (c)'s loss of B and rebuild on C run on a thread beside
    (a), (b) and (d). Returns the launches of the path runtime_gpu."""
    import hashlib
    import threading

    from ray_tpu_torch.core.api import _global_runtime
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.rllib import PPOConfig
    from ray_tpu_torch.util import tree
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy,
    )

    rt = _global_runtime()
    head, node_b = c.nodelets
    t_phase = time.time()
    # every process of the phase starts at once: (c)'s task on node B,
    # (a)'s actor on the head node, (d)'s two runners
    k1 = ray.remote(num_gpus=1, num_cpus=0, resources={"volatile": 1.0},
                    max_retries=2)(_k1_task)
    k1_ref = k1.remote(RUNTIME_K1_SEED)
    Actor = ray.remote(num_gpus=1, runtime_env=env)(RuntimeEnvWorker)
    actor = Actor.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        head.node_id.hex())).remote()
    algo = (PPOConfig().environment("CartPole-v1")
            .env_runners(**RUNTIME_PPO)
            .training(**RUNTIME_PPO_TRAINING)).build()
    d_built_s = time.time() - t_phase
    try:
        # (a) a runtime environment on a GPU actor
        probe = ray.get(actor.probe.remote(), timeout=120)

        # (c) reconstruction on the card, in the background of (a), (b)
        # and (d): node B's output is lost with B and rebuilt on node C
        ready, _ = ray.wait([k1_ref], timeout=120)
        if not ready:
            fail("runtime_gpu: the K1 task on node B did not finish")
        b_pids = set(_node_workers(ray, [node_b]))
        seen_pids.update(b_pids)
        rebuilt: dict = {}

        def reconstruct():
            try:
                t0 = time.perf_counter()
                c.remove_node(node_b)
                deadline = time.monotonic() + CLUSTER_WAIT_S
                while time.monotonic() < deadline and \
                        sum(1 for n in ray.nodes() if n["Alive"]) != 1:
                    time.sleep(0.2)
                rebuilt["dead_s"] = time.perf_counter() - t0
                rebuilt["node"] = c.add_node(num_cpus=0, num_gpus=1,
                                             resources={"volatile": 1.0})
                c.wait_for_nodes()
                rebuilt["t_get"] = time.time()
                rebuilt["value"] = ray.get(k1_ref, timeout=300)
                rebuilt["s"] = time.time() - rebuilt["t_get"]
            except Exception as e:  # noqa: BLE001
                rebuilt["error"] = e

        th = threading.Thread(target=reconstruct,
                              name="runtime-gpu-reconstruct", daemon=True)
        th.start()
        out = ray.get(actor.train.remote(RUNTIME_STEPS), timeout=300)
        a_s = time.time() - t_phase
        state, step, batch = _runtime_gpt2(torch)
        direct = []
        for _ in range(RUNTIME_STEPS):
            state, m = step(state, batch)
            direct.append(m["loss"])
        direct = [float(x) for x in direct]
        del state, step, batch
        release(torch)
        L = 12
        want = {"flash_fwd": 2 * L * RUNTIME_STEPS,
                "flash_dq": L * RUNTIME_STEPS,
                "flash_dkv": L * RUNTIME_STEPS, "paged_attention": 0}
        la = out["launches"]
        if probe["env_var"] != RUNTIME_ENV_VAR[1] or \
                probe["module_value"] != RUNTIME_MODULE_VALUE or \
                not probe["module_file"].startswith(probe["cwd"]) or \
                probe["pid"] == os.getpid() or \
                probe["device_count"] != 1 or \
                probe["name"] != torch.cuda.get_device_name(0):
            fail(f"runtime_gpu: the actor's runtime environment is {probe}")
        if {k: la[k] for k in want} != want:
            fail(f"runtime_gpu: the actor's launches {la}, want {want}")
        if not all(math.isfinite(x) for x in out["losses"]) or \
                out["losses"] != direct:
            fail(f"runtime_gpu: the actor's losses {out['losses']} are not "
                 f"the driver's {direct} bit for bit")
        emit({"phase": "runtime_gpu", "part": "a_runtime_env", "card": card,
              "seconds": a_s, "process_starts": 1,
              "start_split_s": _start_split(probe["start"], t_phase),
              "probe": {k: v for k, v in probe.items() if k != "start"},
              "steps": RUNTIME_STEPS, "losses": out["losses"],
              "losses_bitwise_equal_to_driver": True, "launches": la,
              "launches_per_step": {k: v / RUNTIME_STEPS
                                    for k, v in want.items()}})

        # (b) streaming and spilling of objects made on the card
        t0 = time.perf_counter()
        spill0 = dict(rt.spill_stats)
        gen = actor.stream.options(num_returns="streaming").remote(
            RUNTIME_ITEMS, RUNTIME_ITEM_BYTES)
        refs, t_recv = [], []
        for ref in gen:
            t_recv.append(time.time())
            refs.append(ref)
        stream_s = time.perf_counter() - t0
        spilled = {k: rt.spill_stats[k] - spill0[k] for k in spill0}
        items = []
        t1 = time.perf_counter()
        for ref in refs:  # every ref held until all are read back
            item = ray.get(ref, timeout=CLUSTER_WAIT_S)
            x = item["x"]
            if not x.is_cuda or x.numel() * x.element_size() != \
                    RUNTIME_ITEM_BYTES:
                fail(f"runtime_gpu: an item came back as {x.device} "
                     f"{x.numel() * x.element_size()} bytes")
            sha = hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()
            items.append({"sha_equal": sha == item["sha256"],
                          "t_step_end": item["t_step_end"],
                          "launches": item["launches"]})
            del item, x
        read_s = time.perf_counter() - t1
        del refs, gen
        ray.kill(actor)
        if len(items) != RUNTIME_ITEMS or not all(i["sha_equal"]
                                                  for i in items):
            fail(f"runtime_gpu: {len(items)} items, hashes equal "
                 f"{[i['sha_equal'] for i in items]}")
        if not t_recv[0] < items[-1]["t_step_end"]:
            fail(f"runtime_gpu: the first item reached the driver at "
                 f"{t_recv[0]}, after the producer's last step ended at "
                 f"{items[-1]['t_step_end']}")
        if spilled["bytes"] < RUNTIME_SPILL_MIN:
            fail(f"runtime_gpu: the store spilled {spilled}, below "
                 f"{RUNTIME_SPILL_MIN} bytes")
        lb = items[-1]["launches"]
        want_b = {k: v // RUNTIME_STEPS * RUNTIME_ITEMS
                  for k, v in want.items()}
        if {k: lb[k] for k in want_b} != want_b:
            fail(f"runtime_gpu: the stream's launches {lb}, want {want_b}")
        emit({"phase": "runtime_gpu", "part": "b_stream_spill",
              "card": card, "seconds": stream_s + read_s,
              "stream_s": stream_s, "read_back_s": read_s,
              "process_starts": 0, "items": RUNTIME_ITEMS,
              "item_bytes": RUNTIME_ITEM_BYTES,
              "store_capacity": RUNTIME_STORE_BYTES,
              "first_item_before_last_step_s":
                  items[-1]["t_step_end"] - t_recv[0],
              "item_latency_s": [r - i["t_step_end"]
                                 for r, i in zip(t_recv, items)],
              "spilled_bytes": spilled["bytes"],
              "spilled_objects": spilled["objects"],
              "spill_s": spilled["seconds"],
              "spill_gbps": spilled["bytes"] / spilled["seconds"] / 1e9
              if spilled["seconds"] else None,
              "hashes_equal": True, "launches": lb})

        # (d) PPO with remote runners (built at the phase's start)
        t_d = time.perf_counter()
        group = algo.env_runner_group
        on_cuda("runtime_gpu ppo", algo.learner.params)
        workers = _node_workers(ray, [head])
        by_actor = {a: pid for pid, (a, _) in workers.items() if a}
        pids = [by_actor.get(r._actor_id.hex()) for r in group.runners]
        results = [algo.train() for _ in range(RUNTIME_PPO_ITERS)]
        learner = [np.asarray(x)
                   for x in tree.leaves(algo.learner.get_weights())]
        diffs = []
        for r in group.runners:
            got = tree.leaves(ray.get(r.get_weights.remote(),
                                      timeout=CLUSTER_WAIT_S))
            diffs.append(max(float(np.max(np.abs(np.asarray(a) - b)))
                             for a, b in zip(got, learner)))
        d_s = time.perf_counter() - t_d
        seen_pids.update(workers)
        if len(pids) != RUNTIME_PPO["num_env_runners"] or None in pids or \
                os.getpid() in pids or len(set(pids)) != len(pids):
            fail(f"runtime_gpu: the runners' pids {pids} (driver "
                 f"{os.getpid()})")
        if len(diffs) != len(pids) or max(diffs) != 0.0:
            fail(f"runtime_gpu: the runners' weights differ from the "
                 f"learner's by {diffs}")
        if not all(math.isfinite(r["learner/total_loss"]) for r in results):
            fail("runtime_gpu: a non-finite PPO loss")
        emit({"phase": "runtime_gpu", "part": "d_ppo_remote_runners",
              "card": card, "seconds": d_s,
              "built_at_phase_start_s": d_built_s, "process_starts": 2,
              "spawn_to_ready_s": sorted(
                  workers[p][1] for p in pids if workers[p][1] is not None),
              "runner_pids": pids, "driver_pid": os.getpid(),
              "iterations": RUNTIME_PPO_ITERS,
              "weights_max_abs_diff": max(diffs),
              "env_steps_per_sec": [r["env_steps_per_sec"] for r in results],
              "time_sample_s": [r["time_sample_s"] for r in results],
              "time_learn_s": [r["time_learn_s"] for r in results],
              "episode_return_mean": [r["episode_return_mean"]
                                      for r in results],
              "ppo_cartpole_local_env_steps_per_sec": ppo_local})

        th.join(timeout=400)
        if "value" not in rebuilt:
            fail(f"runtime_gpu: the K1 output was not rebuilt: {rebuilt}")
        o, launches, pid, start = rebuilt["value"]
        c_pids = set(_node_workers(ray, [rebuilt["node"]]))
        seen_pids.update(c_pids)
    finally:
        algo.stop()
    q, k, v = _k1_inputs(torch, RUNTIME_K1_SEED)
    want_o = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    equal = bool(o.is_cuda and o.shape == want_o.shape and
                 o.dtype == want_o.dtype and torch.equal(o, want_o))
    del q, k, v, want_o, o
    if pid not in c_pids or pid in b_pids:
        fail(f"runtime_gpu: the rebuilt K1 output came from pid {pid}, "
             f"not node C's {sorted(c_pids)}")
    if launches.get("flash_fwd") != 1:
        fail(f"runtime_gpu: the rebuilding task launched {launches}")
    if not equal:
        fail("runtime_gpu: the rebuilt K1 output differs from the "
             "driver's K1 call on the same inputs")
    emit({"phase": "runtime_gpu", "part": "c_reconstruction", "card": card,
          "seconds": rebuilt["dead_s"] + rebuilt["s"],
          "death_seen_s": rebuilt["dead_s"], "rebuild_s": rebuilt["s"],
          "rebuild_start_split_s": _start_split(start, rebuilt["t_get"]),
          "process_starts": len(b_pids) + len(c_pids),
          "shape": list(RUNTIME_K1_SHAPE), "dtype": "bfloat16",
          "bitwise_equal_to_driver": True, "launches": launches})
    return {k: la[k] + lb[k] + (launches[k] if k == "flash_fwd" else 0)
            for k in want}


def phase_runtime_gpu(torch, card: str, ppo_local: dict | None) -> dict:
    """Phase 17: runtime environments, streaming and spilling of CUDA
    tensors, reconstruction and remote env runners on the card (see the
    docstring); returns the launches of the path runtime_gpu."""
    import shutil
    import tempfile

    import ray_tpu_torch as ray
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core import object_store

    t_phase = time.perf_counter()
    release(torch)
    wd = tempfile.mkdtemp(prefix="runtime_gpu_wd_")
    with open(os.path.join(wd, f"{RUNTIME_MODULE}.py"), "w") as f:
        f.write(f"VALUE = {RUNTIME_MODULE_VALUE!r}\n")
    env = {"env_vars": dict([RUNTIME_ENV_VAR]), "working_dir": wd}
    # the head node is what init() boots (this process, the card's GPU
    # count), with the 512 MiB store; node B gets the card for (c)
    c = Cluster(initialize_head=True, head_node_args={
        "num_cpus": os.cpu_count() or 8,
        "num_gpus": torch.cuda.device_count(),
        "store_capacity": RUNTIME_STORE_BYTES})
    stores = [c.nodelets[0].store.name]
    seen_pids: set = set()
    try:
        node_b = c.add_node(num_cpus=0, num_gpus=1,
                            resources={"volatile": 1.0})
        stores.append(node_b.store.name)
        c.wait_for_nodes()
        ray.init(address=c.address)
        launches = _runtime_parts(torch, ray, c, card, env, ppo_local,
                                  seen_pids)
        stores.append(c.nodelets[-1].store.name)
    finally:
        ray.shutdown()
        c.shutdown()
        shutil.rmtree(wd, ignore_errors=True)
    release(torch)
    left = [s for s in stores
            if os.path.exists(os.path.join(object_store._SHM_DIR, s))]
    if left:
        fail(f"runtime_gpu: store segments {left} outlived shutdown()")
    alive = []
    for pid in seen_pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    if alive:
        fail(f"runtime_gpu: worker processes {alive} outlived shutdown()")
    emit({"phase": "runtime_gpu", "card": card, "launches": launches,
          "worker_pids_checked": len(seen_pids),
          "phase_s": time.perf_counter() - t_phase})
    return launches

# ------------------------------------------------------------ phase 18


def _serve_replica_class():
    """Phase 18's deployment class: a subclass of LLMServer defined
    here (so pickled by value) that times its process's start, warms up
    apart from the engine's build, and answers its launch counters, its
    params' checksum and, from `update_weights`, the seconds the store's
    get took."""
    from ray_tpu_torch.serve.llm.deployment import LLMServer

    class ServeReplica(LLMServer):
        def __init__(self, engine_config, warmup: bool = True,
                     device=None, **cfg_kwargs):
            t0 = time.time()
            import torch

            t_torch = time.time()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.cuda.set_device(0)  # raises when the card is hidden
            torch.ones(1, device="cuda").sum().item()
            t1 = time.time()
            super().__init__(engine_config, warmup=False, device=device,
                             **cfg_kwargs)
            t2 = time.time()
            shapes = self.engine.warmup() if warmup else 0
            torch.cuda.synchronize()
            self.start = {"pid": os.getpid(), "proc_start": _proc_start(),
                          "init_start": t0, "torch_imported": t_torch,
                          "cuda_ready": t1,
                          "engine_built": t2, "warm": time.time(),
                          "warmup_shapes": shapes,
                          "card": torch.cuda.get_device_name(0)}

        def process_start(self) -> dict:
            return self.start

        def counters(self, reset: bool = False) -> dict:
            """This process's launches (zeroed first with `reset`)."""
            return launch_counts(_reset_counters() if reset
                                 else _launch_counters())

        def checksum(self) -> list:
            return _param_checksum(self.engine.runner.params)

        def update_weights(self, version: int, weights) -> dict:
            import ray_tpu_torch as ray
            from ray_tpu_torch.core.api import ObjectRef

            t0 = time.perf_counter()
            if isinstance(weights, ObjectRef):
                weights = ray.get(weights)
            get_s = time.perf_counter() - t0
            out = super().update_weights(version, weights)
            return dict(out, get_s=get_s)

    return ServeReplica


def _control(replica, method: str, *args):
    """Call a deployment method on one replica over its control lane."""
    return replica.handle_request.options(
        concurrency_group="control").remote(method, args, {})


def _param_checksum(params) -> list:
    """Each param's float64 sum and sum of squares."""
    from ray_tpu_torch.util import tree

    return [[float(t.double().sum()), float(t.double().square().sum())]
            for t in tree.leaves(params)]


def _stream_wave(ray, handle, prompts, max_tokens: int, hook=None) -> dict:
    """Stream every prompt at once through the handle, each consumed on
    its own thread: the events per stream, TTFT (s from the submission
    to the first event), the wall time and the errors. With `hook`,
    every consumer parks after its second event until the hook has run
    (so it fires while every stream is in flight)."""
    import threading

    sh = handle.options(stream=True)
    n = len(prompts)
    events, first, errors = [None] * n, [None] * n, []
    barrier = threading.Barrier(n + 1, timeout=SERVE_WAIT_S) if hook \
        else None
    resume = threading.Event()
    if hook is None:
        resume.set()

    def consume(i, gen, t_sub):
        try:
            evs = []
            for ref in gen:
                evs.append(ray.get(ref, timeout=SERVE_WAIT_S))
                if len(evs) == 1:
                    first[i] = time.perf_counter() - t_sub
                if barrier is not None and len(evs) == 2:
                    barrier.wait()
                    resume.wait(timeout=SERVE_WAIT_S)
            events[i] = evs
        except Exception as e:  # noqa: BLE001
            errors.append((i, repr(e)))

    t0 = time.perf_counter()
    threads = []
    for i, p in enumerate(prompts):
        gen = sh.remote({"prompt": p, "max_tokens": max_tokens})
        threads.append(threading.Thread(
            target=consume, args=(i, gen, time.perf_counter()),
            daemon=True))
        threads[-1].start()
    out = {"hook": None}
    if barrier is not None:
        try:
            barrier.wait()
            out["hook"] = hook()
        finally:
            resume.set()
    for t in threads:
        t.join(timeout=SERVE_WAIT_S * 2)
    out.update(events=events, ttft_s=first, errors=errors,
               wall_s=time.perf_counter() - t0)
    return out


def _check_streams(what: str, events, max_tokens: int) -> list:
    """One event a token, contiguous indices, a final by length; returns
    the token lists."""
    out = []
    for i, evs in enumerate(events):
        if evs is None:
            fail(f"{what}: stream {i} never finished")
        *toks, final = evs
        if not final.get("done") or final.get("finish_reason") != "length" \
                or len(toks) != max_tokens \
                or [e["index"] for e in toks] != list(range(len(toks))) \
                or [e["token"] for e in toks] != final["token_ids"]:
            fail(f"{what}: stream {i}: {len(toks)} token events, indices "
                 f"{[e.get('index') for e in toks][:8]}..., final "
                 f"{ {k: v for k, v in final.items() if k != 'logprobs'} }")
        out.append(list(final["token_ids"]))
    return out


def _tie_check(torch, what: str, compute, cfg, prompts, streams,
               refs) -> dict:
    """Each stream against its reference: equal, or, from the first
    token where it differs, every token within LOGITS_TOL["max_abs"] of
    its row's max in one fresh prefill (K1) over prompt + stream."""
    from ray_tpu_torch.models.gpt2 import gpt2_prefill_kv

    equal, checked, not_argmax, worst = 0, 0, 0, 0.0
    for prompt, gen, ref in zip(prompts, streams, refs):
        if gen == ref:
            equal += 1
            continue
        d = next(i for i, (a, b) in enumerate(zip(gen, ref)) if a != b)
        full = torch.tensor([prompt + gen[:-1]], device="cuda")
        with torch.no_grad():
            logits, _, _ = gpt2_prefill_kv(compute, full, cfg)
        rows = logits[0, len(prompt) - 1 + d:, :cfg.vocab_size].float()
        gap = rows.max(-1).values - rows.gather(
            -1, torch.tensor(gen[d:], device="cuda")[:, None])[:, 0]
        checked += len(gen) - d
        not_argmax += int((gap > 0).sum())
        worst = max(worst, float(gap.max()))
    out = {"streams_equal": equal, "streams": len(streams),
           "tokens_checked": checked, "tokens_not_argmax": not_argmax,
           "max_gap_to_argmax": worst, "gap_tol": LOGITS_TOL["max_abs"]}
    if worst > LOGITS_TOL["max_abs"]:
        fail(f"{what}: a token's logit is {worst} below its row's max: "
             f"{out}")
    return out


def _proxy_stream(address: str, payload: dict) -> list[dict]:
    """POST `payload` to the proxy's NDJSON path; the results."""
    import urllib.request

    req = urllib.request.Request(
        f"http://{address}/{SERVE_APP}?stream=1",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=SERVE_WAIT_S) as resp:
        lines = [json.loads(x) for x in resp.read().splitlines()
                 if x.strip()]
    bad = [x for x in lines if "result" not in x]
    if bad:
        fail(f"serve_gpt2: the proxy streamed {bad[0]}")
    return [x["result"] for x in lines]


def _replica_start(start: dict, submitted: float, ready_s) -> dict:
    """Seconds from the submission to a replica's process start, to its
    worker's registration, to its __init__, to torch imported, to its
    CUDA context, to the engine built (the serving modules' import
    included) and to the end of its warmup."""
    marks = [("to_process", start["proc_start"]),
             ("worker_ready", start["proc_start"] + (ready_s or 0.0)),
             ("to_init", start["init_start"]),
             ("torch_import", start["torch_imported"]),
             ("cuda_context", start["cuda_ready"]),
             ("engine_build", start["engine_built"]),
             ("warmup", start["warm"])]
    out, prev = {}, submitted
    for name, t in marks:
        out[name] = t - prev
        prev = t
    return out


def _wait_healed(serve, target: int) -> tuple[bool, dict]:
    """Poll serve.status() until the app has restarted a replica and is
    back to `target` healthy ones with none being replaced: (healed,
    the last health record). Never calls fail (it runs on a thread)."""
    deadline = time.monotonic() + SERVE_WAIT_S
    hl: dict = {}
    while time.monotonic() < deadline:
        hl = serve.status()["health"].get(SERVE_APP, {})
        if hl.get("restarts", 0) >= 1 and hl.get("healthy") == target \
                and hl.get("replacing") == 0:
            return True, hl
        time.sleep(0.2)
    return False, hl


def _serve_parts(torch, ray, serve, c, card: str, ref: dict) -> dict:
    """Phase 18's three parts on the cluster `c`; returns the launches
    of the path serve_gpt2."""
    import dataclasses
    import threading

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.rllib.llm import (
        DigitSumTask,
        LLMLearner,
        LLMLearnerConfig,
        RolloutConfig,
        RolloutWorker,
    )
    from ray_tpu_torch.serve.api import _replica_ident
    from ray_tpu_torch.serve.llm import build_llm_app
    from ray_tpu_torch.serve.llm.runner import adapters
    from ray_tpu_torch.util import chaos
    from ray_tpu_torch.util.state import llm_status

    app = build_llm_app(
        model="gpt2", preset="small", num_replicas=SERVE_REPLICAS,
        engine_config={"block_size": 16, "max_model_len": 1024,
                       "max_batch_size": 8, "prefill_chunk_size": 0,
                       "use_paged_attention": True, "speculative": None,
                       "seed": 0, "num_blocks": SERVE_NUM_BLOCKS},
        ray_actor_options={"num_gpus": SERVE_GPU_SHARE},
        max_ongoing_requests=16)
    app = dataclasses.replace(app, deployment=app.deployment.options(
        cls_or_fn=_serve_replica_class()))
    # the controller, both replicas and the proxy start at once; the
    # driver builds the learner meanwhile
    started: dict = {}

    def start(name, fn):
        try:
            started[name] = fn()
        except Exception as e:  # noqa: BLE001
            started[name] = e

    t_submit = time.time()
    threads = [threading.Thread(target=start, args=args, daemon=True)
               for args in (("handle", lambda: serve.run(
                   app, name=SERVE_APP)),
                   ("proxy", lambda: serve.start_proxy(port=0)))]
    for t in threads:
        t.start()
    cfg = GPT2Config.small()
    learner = LLMLearner("gpt2", cfg, config=LLMLearnerConfig(), seed=0)
    # the replicas' compute params (bf16 copies of the same seed-0
    # masters), for the tie check; dropped before the learner updates
    compute = adapters()["gpt2"].serving_params_fn(learner.state.params,
                                                   cfg)
    want_sum = _param_checksum(learner.state.params)
    for t in threads:
        t.join(timeout=SERVE_WAIT_S * 2)
    for name in ("handle", "proxy"):
        if isinstance(started.get(name), Exception) or name not in started:
            fail(f"serve_gpt2: {name} did not start: {started.get(name)!r}")
    handle, proxy = started["handle"], started["proxy"]
    setup_s = time.time() - t_submit
    replicas = chaos.list_replicas(SERVE_APP)
    starts = ray.get([_control(r, "process_start") for r in replicas],
                     timeout=SERVE_WAIT_S)
    sums = ray.get([_control(r, "checksum") for r in replicas],
                   timeout=SERVE_WAIT_S)
    workers = _node_workers(ray, c.nodelets)
    if len(replicas) != SERVE_REPLICAS or any(s != want_sum for s in sums):
        fail(f"serve_gpt2: {len(replicas)} replicas; params equal to the "
             f"driver's seed-0 GPT-2-small: {[s == want_sum for s in sums]}")
    pids = [s["pid"] for s in starts]
    if len(set(pids)) != SERVE_REPLICAS or os.getpid() in pids or \
            any(s["card"] != torch.cuda.get_device_name(0) for s in starts):
        fail(f"serve_gpt2: the replicas' processes {starts}")
    emit({"phase": "serve_gpt2", "part": "setup", "card": card,
          "seconds": setup_s, "process_starts": len(workers),
          "replica_start_split_s": [
              _replica_start(s, t_submit, workers.get(s["pid"], (0, 0))[1])
              for s in starts],
          "warmup_s": [s["warm"] - s["engine_built"] for s in starts],
          "warmup_shapes": [s["warmup_shapes"] for s in starts],
          "params_equal_to_driver": True, "proxy": proxy})

    # (a) phase 3's prompts, streamed at once, and one more by HTTP
    prompts, want = ref["prompts"], ref["streams"]
    ray.get([_control(r, "counters", True) for r in replicas],
            timeout=SERVE_WAIT_S)
    wave1 = _stream_wave(ray, handle, prompts, MAX_TOKENS)
    if wave1["errors"]:
        fail(f"serve_gpt2: wave 1 failed: {wave1['errors']}")
    streams1 = _check_streams("serve_gpt2 wave 1", wave1["events"],
                              MAX_TOKENS)
    t0 = time.perf_counter()
    via_proxy = _proxy_stream(proxy, {"prompt": prompts[0],
                                      "max_tokens": MAX_TOKENS})
    proxy_s = time.perf_counter() - t0
    proxy_tokens = _check_streams("serve_gpt2 proxy", [via_proxy],
                                  MAX_TOKENS)[0]
    counts = ray.get([_control(r, "counters") for r in replicas],
                     timeout=SERVE_WAIT_S)
    launches_a = {k: sum(c[k] for c in counts)
                  for k in ("flash_fwd", "flash_dq", "flash_dkv",
                            "paged_attention")}
    if any(c["flash_fwd"] <= 0 or c["paged_attention"] <= 0
           for c in counts):
        fail(f"serve_gpt2: a replica launched no K1 or no K4: {counts}")
    tie1 = _tie_check(torch, "serve_gpt2 wave 1", compute, cfg, prompts,
                      streams1, want)
    tie_proxy = _tie_check(torch, "serve_gpt2 proxy", compute, cfg,
                           prompts[:1], [proxy_tokens], want[:1])
    n_tok = sum(len(x) for x in streams1)
    emit({"phase": "serve_gpt2", "part": "a_streams", "card": card,
          "requests": len(prompts), "max_tokens": MAX_TOKENS,
          "wall_s": wave1["wall_s"],
          "tokens_per_s": n_tok / wave1["wall_s"],
          "ttft_ms_p50": float(np.median(wave1["ttft_s"])) * 1e3,
          "ttft_ms_max": max(wave1["ttft_s"]) * 1e3,
          "engine_tokens_per_s": ref.get("tokens_per_s"),
          "engine_ttft_ms_p50": ref.get("ttft_ms_p50"),
          "check": tie1, "proxy_s": proxy_s, "proxy_check": tie_proxy,
          "launches_by_replica": counts, "launches": launches_a})

    # (b) the same streams again; a replica is killed mid-generation
    before = {_replica_ident(r) for r in replicas}
    killed: dict = {}

    def kill():
        killed["t"] = time.time()
        killed["ident"] = chaos.kill_replica(SERVE_APP, busiest=True)

    healed: dict = {}

    def heal():
        try:
            ok, hl = _wait_healed(serve, SERVE_REPLICAS)
            if not ok:
                healed["error"] = f"the app never healed: {hl}"
                return
            new = [r for r in chaos.list_replicas(SERVE_APP)
                   if _replica_ident(r) not in before]
            if len(new) != 1:
                healed["error"] = f"{len(new)} new replicas"
                return
            gen = new[0].handle_stream_request.options(
                num_returns="streaming").remote(
                "__call__", ({"prompt": prompts[-1], "max_tokens": 4},), {})
            evs = [ray.get(next(gen), timeout=SERVE_WAIT_S)]
            healed["first_token_t"] = time.time()
            evs += [ray.get(r, timeout=SERVE_WAIT_S) for r in gen]
            healed.update(health=hl, events=evs, replica=new[0],
                          start=ray.get(_control(new[0], "process_start"),
                                        timeout=SERVE_WAIT_S))
        except Exception as e:  # noqa: BLE001
            healed["error"] = repr(e)

    def kill_and_watch():
        kill()
        th = threading.Thread(target=heal, name="serve-heal-watch",
                              daemon=True)
        th.start()
        return th

    wave2 = _stream_wave(ray, handle, prompts, MAX_TOKENS,
                         hook=kill_and_watch)
    heal_thread = wave2["hook"]
    if wave2["errors"] or "ident" not in killed:
        fail(f"serve_gpt2: wave 2 failed through the kill: "
             f"{wave2['errors']}")
    streams2 = _check_streams("serve_gpt2 wave 2", wave2["events"],
                              MAX_TOKENS)
    failovers = sum(e[-1].get("failovers", 0) for e in wave2["events"])
    if failovers < 1:
        fail("serve_gpt2: the kill landed on no stream")
    tie2 = _tie_check(torch, "serve_gpt2 wave 2", compute, cfg, prompts,
                      streams2, streams1)
    del compute
    emit({"phase": "serve_gpt2", "part": "b_kill", "card": card,
          "wall_s": wave2["wall_s"], "failovers": failovers,
          "check_against_wave_1": tie2})

    # (c) one GRPO lap through the handle, while the replacement starts
    task = DigitSumTask(prefix_len=RL_PREFIX)
    rng = np.random.RandomState(18)
    lap_prompts = [[task.make_prompt(int(a), int(b))]
                   for a, b in rng.randint(0, 10, (2, 2))]
    worker = RolloutWorker(handle=handle, reward_fn=even_share,
                           config=RolloutConfig(group_size=RL_GROUP,
                                                max_tokens=RL_TOKENS,
                                                temperature=1.0))
    t0 = time.perf_counter()
    trajs0 = worker.rollout(lap_prompts[0])
    rollout0_s = time.perf_counter() - t0
    contract0 = _rl_logprob_contract(learner, trajs0, None,
                                     "serve_gpt2 lap (version 0)")
    torch.cuda.synchronize()
    counters = _reset_counters()
    t0 = time.perf_counter()
    metrics = learner.update(trajs0)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    launches_c = launch_counts(counters)
    want_c = {"flash_fwd": 2 * cfg.n_layer, "flash_dq": cfg.n_layer,
              "flash_dkv": cfg.n_layer, "paged_attention": 0}
    if {k: launches_c[k] for k in want_c} != want_c or \
            not math.isfinite(metrics["loss"]):
        fail(f"serve_gpt2: the update launched {launches_c}, want "
             f"{want_c}; loss {metrics.get('loss')}")
    t0 = time.perf_counter()
    version, weights = learner.publish_weights()
    publish_s = time.perf_counter() - t0
    if version != 1 or not isinstance(weights, ray.ObjectRef):
        fail(f"serve_gpt2: publish_weights gave version {version}, "
             f"{type(weights).__name__}")
    t0 = time.perf_counter()
    swap = handle.update_weights(version, weights)
    swap_s = time.perf_counter() - t0
    if not swap or any(s.get("version") != 1 or "error" in s for s in swap):
        fail(f"serve_gpt2: update_weights gave {swap}")
    heal_thread.join(timeout=SERVE_WAIT_S * 2)
    if "first_token_t" not in healed:
        fail(f"serve_gpt2: the replacement did not answer: {healed}")
    stats = llm_status(SERVE_APP)
    if len(stats) != SERVE_REPLICAS or \
            any(s["weight_version"] != 1 for s in stats):
        fail(f"serve_gpt2: the replicas' weight versions "
             f"{[s['weight_version'] for s in stats]}, want 1 on "
             f"{SERVE_REPLICAS}")
    t0 = time.perf_counter()
    trajs1 = worker.rollout(lap_prompts[1])
    rollout1_s = time.perf_counter() - t0
    contract1 = _rl_logprob_contract(learner, trajs1, None,
                                     "serve_gpt2 lap (version 1)",
                                     version=1)
    hl = serve.status()["health"][SERVE_APP]
    if hl["restarts"] < 1 or hl["healthy"] != SERVE_REPLICAS:
        fail(f"serve_gpt2: health after the heal {hl}")
    new_start = healed["start"]
    emit({"phase": "serve_gpt2", "part": "heal", "card": card,
          "kill_to_replacement_first_token_s":
              healed["first_token_t"] - killed["t"],
          "restarts": hl["restarts"], "healthy": hl["healthy"],
          "replacement_start_split_s": _replica_start(
              new_start, killed["t"], _node_workers(ray, c.nodelets).get(
                  new_start["pid"], (0, 0))[1]),
          "lifecycle": [e["event"] for e in hl["lifecycle"]]})
    emit({"phase": "serve_gpt2", "part": "c_grpo_lap", "card": card,
          "group_size": RL_GROUP, "max_tokens": RL_TOKENS,
          "rollout_s": [rollout0_s, rollout1_s], "update_s": update_s,
          "loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
          "publish_s": publish_s, "update_weights_s": swap_s,
          "replica_get_s": [s.get("get_s") for s in swap],
          "replica_swap_s": [s.get("swap_seconds") for s in swap],
          "weight_versions": [s["weight_version"] for s in stats],
          "logprob_contract_v0": contract0,
          "logprob_contract_v1": contract1, "launches": launches_c})
    del learner
    return {k: launches_a[k] + launches_c[k] for k in want_c}


def phase_serve_gpt2(torch, card: str, ref: dict) -> dict:
    """Phase 18: Serve on the cluster runtime with two GPT-2-small
    replicas on the card (see the docstring); `ref` holds phase 3's
    prompts and streams. Returns the launches of the path serve_gpt2."""
    import ray_tpu_torch as ray
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core import object_store

    t_phase = time.perf_counter()
    release(torch)
    c = Cluster(initialize_head=True, head_node_args={
        "num_cpus": os.cpu_count() or 8,
        "num_gpus": torch.cuda.device_count(),
        "store_capacity": SERVE_STORE_BYTES})
    stores = [c.nodelets[0].store.name]
    seen_pids: set = set()
    try:
        c.wait_for_nodes()
        ray.init(address=c.address)
        launches = _serve_parts(torch, ray, serve, c, card, ref)
        seen_pids.update(_node_workers(ray, c.nodelets))
    finally:
        try:
            serve.shutdown()
        finally:
            ray.shutdown()
            c.shutdown()
    release(torch)
    left = [s for s in stores
            if os.path.exists(os.path.join(object_store._SHM_DIR, s))]
    if left:
        fail(f"serve_gpt2: store segments {left} outlived shutdown()")
    alive = []
    for pid in seen_pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    if alive:
        fail(f"serve_gpt2: worker processes {alive} outlived shutdown()")
    emit({"phase": "serve_gpt2", "card": card, "launches": launches,
          "worker_pids_checked": len(seen_pids),
          "phase_s": time.perf_counter() - t_phase})
    return launches


# ------------------------------------------------------------ phase 19


def _dag_stage(params, cfg, x, stage: int):
    """Stage `stage` of phase 19's two-stage GPT-2-small forward: stage 0
    takes tokens (B, T) to the residual stream after blocks [0,
    DAG_SPLIT); stage 1 runs the other blocks and the final norm and
    returns the last position's logits (B, padded vocab) in f32."""
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.util import tree

    blocks = tree.unstack(params["blocks"])
    with torch.no_grad():
        if stage == 0:
            pos = torch.arange(x.shape[1], device=x.device)
            x = gpt2._embed(params, x, pos, cfg)
            for p in blocks[:DAG_SPLIT]:
                x = gpt2._block(x, p, cfg)
            return x
        for p in blocks[DAG_SPLIT:]:
            x = gpt2._block(x, p, cfg)
        return gpt2._logits(params, x[:, -1:], cfg)[:, 0]


def _lm_grads(params, batch: dict, cfg):
    """The LM loss's gradients as train's step takes them
    (``torch.autograd.grad`` of `gpt2_loss` over the params' leaves):
    (grads in the params' tree, the loss)."""
    import torch

    from ray_tpu_torch.models.gpt2 import gpt2_loss
    from ray_tpu_torch.util import tree

    inputs = [t.detach().requires_grad_() for t in tree.leaves(params)]
    loss = gpt2_loss(tree.unflatten(params, inputs), batch, cfg)
    grads = torch.autograd.grad(loss, inputs)
    return tree.unflatten(params, list(grads)), loss.detach()


def _dp_batch(torch, vocab: int, rank: int) -> dict:
    """Rank `rank`'s batch of the data-parallel step: train's shape,
    tokens from seed DAG_DP_SEED + rank."""
    B, T = TRAIN_BATCH
    gen = torch.Generator(device="cuda")
    gen.manual_seed(DAG_DP_SEED + rank)
    toks = torch.randint(0, vocab, (B, T + 1), generator=gen, device="cuda")
    return {"tokens": toks[:, :-1].contiguous(),
            "targets": toks[:, 1:].contiguous()}


def _send_tensor(torch):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(DAG_SEND_SEED)
    return torch.randn(DAG_SEND_BYTES // 4, generator=gen, device="cuda")


def _trees_equal(torch, a, b) -> tuple[bool, float]:
    """(every leaf bit-equal, the largest elementwise difference)."""
    from ray_tpu_torch.util import tree

    la, lb = tree.leaves(a), tree.leaves(b)
    if len(la) != len(lb):
        return False, math.inf
    if all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
           for x, y in zip(la, lb)):
        return True, 0.0
    return False, max((x.float() - y.float()).abs().max().item()
                      if x.shape == y.shape else math.inf
                      for x, y in zip(la, lb))


def _observe_leaf() -> dict:
    """Phase 20 (c)'s task: the trace context it runs under."""
    from ray_tpu_torch.util import tracing

    return tracing.current_trace()


def _observe_loop(params, cfg, seconds: float) -> dict:
    """Phase 20 (c)'s loop: train's recipe (`_gpt2_train_setup`) on a
    copy of `params` and a batch of seed OBSERVE_SEED, steps until
    `seconds` have passed; the steps and their losses."""
    import torch

    from ray_tpu_torch.util import tree

    gen = torch.Generator(device="cuda")
    gen.manual_seed(OBSERVE_SEED)
    state, step, batch = _gpt2_train_setup(
        torch, tree.tree_map(torch.clone, params), cfg, gen)
    losses = []
    t_end = time.perf_counter() + seconds
    while not losses or time.perf_counter() < t_end:
        state, m = step(state, batch)
        losses.append(m["loss"])
    return {"steps": len(losses), "losses": [float(x) for x in losses]}


class DagStage:
    """Phase 19's actor, defined in this script (``__main__``), so the
    cluster pickles it by value: a stage of the compiled pipeline and a
    rank of the data-parallel step, holding GPT-2-small's params from
    the driver's one put."""

    def __init__(self, refs: list, rank: int):
        self.start = {"proc_start": _proc_start(), "init_start": time.time()}
        import torch

        self.start["torch_imported"] = time.time()
        import ray_tpu_torch as ray
        from ray_tpu_torch.models.gpt2 import GPT2Config

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        torch.ones(1, device="cuda").sum().item()
        self.start["cuda_ready"] = time.time()
        self.params = ray.get(refs[0], timeout=DAG_WAIT_S)
        torch.cuda.synchronize()
        self.start["params_ready"] = time.time()
        self.rank = rank
        self.cfg = GPT2Config.small()
        self.comm = None

    def info(self) -> dict:
        return {"pid": os.getpid(), "rank": self.rank, "start": self.start,
                "checksum": _param_checksum(self.params)}

    def observe_chain(self) -> dict:
        """Phase 20 (c): under the caller's trace, one print, one
        logging record and one task; the trace contexts seen here and
        in the task."""
        import logging

        import ray_tpu_torch as ray
        from ray_tpu_torch.util import tracing

        trace = tracing.current_trace()
        print(f"observe_gpt2 print {trace['trace_id']}", flush=True)
        logging.getLogger("observe_gpt2").warning(
            "observe_gpt2 log %s", trace["trace_id"])
        leaf = ray.get(ray.remote(num_cpus=0.1)(_observe_leaf).remote(),
                       timeout=DAG_WAIT_S)
        return {"actor": trace, "leaf": leaf, "pid": os.getpid()}

    def observe_train(self, seconds: float) -> dict:
        """Phase 20 (c): GPT-2-small train steps in this process for
        `seconds` (`_observe_loop`)."""
        return _observe_loop(self.params, self.cfg, seconds)

    def stage0(self, tokens):
        return _dag_stage(self.params, self.cfg, tokens, 0)

    def stage1(self, x):
        return _dag_stage(self.params, self.cfg, x, 1)

    def reset_counters(self) -> None:
        _reset_counters()

    def launches(self) -> dict:
        return launch_counts(_launch_counters())

    def warm(self) -> float:
        """This process's first forward of its stage and first backward
        (the kernels' and cuBLAS's first loads), at small shapes, before
        the timed parts; the launch counters are zeroed after."""
        import torch

        t0 = time.perf_counter()
        toks = torch.zeros((1, 128), dtype=torch.long, device="cuda")
        x = _dag_stage(self.params, self.cfg, toks, 0)
        _dag_stage(self.params, self.cfg, x, 1)
        _lm_grads(self.params, {"tokens": toks, "targets": toks}, self.cfg)
        torch.cuda.synchronize()
        _reset_counters()
        return time.perf_counter() - t0

    def time_stage(self, x, stage: int, n: int) -> float:
        """Median ms of `stage` on `x` in this process, synchronised."""
        import torch

        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _dag_stage(self.params, self.cfg, x, stage)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    def join(self) -> float:
        """Join the group; one small allreduce warms its coordinator
        (whose first tensor imports torch there)."""
        import torch

        from ray_tpu_torch.util import collective as col

        t0 = time.perf_counter()
        col.init_collective_group(2, self.rank, group_name=DAG_GROUP)
        col.allreduce(torch.ones(1, device="cuda"), group_name=DAG_GROUP)
        return time.perf_counter() - t0

    def dp_step(self, refs: list) -> dict:
        """The LM grads of this rank's batch with the launch counters
        zeroed just before and read just after, averaged through the
        group and held against the driver's average (refs[0]); then
        rank 0's params broadcast and the two losses gathered."""
        import torch

        import ray_tpu_torch as ray
        from ray_tpu_torch.util import collective as col
        from ray_tpu_torch.util import tree

        batch = _dp_batch(torch, self.cfg.vocab_size, self.rank)
        torch.cuda.synchronize()
        counters = _reset_counters()
        t0 = time.perf_counter()
        grads, loss = _lm_grads(self.params, batch, self.cfg)
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
        launches = launch_counts(counters)
        nbytes = sum(t.numel() * t.element_size()
                     for t in tree.leaves(grads))
        col.barrier(DAG_GROUP)  # time the allreduce, not the other rank
        t0 = time.perf_counter()
        avg = col.allreduce(grads, group_name=DAG_GROUP,
                            op=col.ReduceOp.MEAN)
        torch.cuda.synchronize()
        allreduce_s = time.perf_counter() - t0
        del grads
        placed = sorted({(type(t).__name__, str(t.device))
                         for t in tree.leaves(avg)})
        want = ray.get(refs[0], timeout=DAG_WAIT_S)
        avg_equal, avg_diff = _trees_equal(torch, avg, want)
        del avg, want
        t0 = time.perf_counter()
        got = col.broadcast(self.params, src_rank=0, group_name=DAG_GROUP)
        torch.cuda.synchronize()
        broadcast_s = time.perf_counter() - t0
        params_equal, _ = _trees_equal(torch, got, self.params)
        got_on = sorted({str(t.device) for t in tree.leaves(got)})
        del got
        losses = col.allgather(loss, group_name=DAG_GROUP)
        col.barrier(DAG_GROUP)
        return {"pid": os.getpid(), "launches": launches, "grad_s": grad_s,
                "grad_bytes": nbytes, "allreduce_s": allreduce_s,
                "avg_placed": placed, "avg_equal": avg_equal,
                "avg_max_diff": avg_diff, "broadcast_s": broadcast_s,
                "broadcast_equal": params_equal, "broadcast_on": got_on,
                "losses": [float(x) for x in losses],
                "losses_on": sorted({str(x.device) for x in losses})}

    def make_comm(self, name: str) -> None:
        from ray_tpu_torch.experimental.channel import ShmCommunicator

        self.comm = ShmCommunicator(name, 2, self.rank,
                                    capacity=2 * DAG_SEND_BYTES + (1 << 20))

    def send_recv(self) -> dict:
        """DAG_SEND_BYTES from rank 0 to rank 1 through the collective's
        send/recv, then through the ShmCommunicator; rank 1 times each
        from the barrier before it to the tensor on its card."""
        import torch

        from ray_tpu_torch.util import collective as col

        x = _send_tensor(torch)
        out = {}
        for how in ("collective", "channel"):
            col.barrier(DAG_GROUP)
            t0 = time.perf_counter()
            if self.rank == 0:
                if how == "collective":
                    col.send(x, 1, group_name=DAG_GROUP)
                else:
                    self.comm.send(x, 1, timeout=DAG_WAIT_S)
                out[how] = {"s": time.perf_counter() - t0}
                continue
            y = (col.recv(0, group_name=DAG_GROUP) if how == "collective"
                 else self.comm.recv(0, timeout=DAG_WAIT_S))
            arrived_on = str(y.device)
            y = y.to("cuda")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            out[how] = {"s": dt, "gbps": DAG_SEND_BYTES / dt / 1e9,
                        "arrived_on": arrived_on,
                        "equal": bool(torch.equal(y, x))}
        col.barrier(DAG_GROUP)
        self.comm.destroy()
        self.comm = None
        out["collective_seconds"] = col._collective_seconds().sums_by_tag(
            "op")
        return out


def _dag_counts() -> dict:
    """dag_executions_total by path, in this process."""
    from ray_tpu_torch.util.metrics import prometheus_text

    out = {"compiled": 0.0, "eager_fallback": 0.0}
    for line in prometheus_text().splitlines():
        for path in out:
            if line.startswith(f'dag_executions_total{{path="{path}"}}'):
                out[path] = float(line.rsplit(" ", 1)[1])
    return out


# the RPCs that a compiled graph's steady state may not make
HEAD_RPCS = ("get_actor", "create_actor", "kv_put", "kv_get")
NODELET_RPCS = ("schedule_task", "schedule_tasks", "request_lease",
                "start_actor")


def _rpc_counts(server, methods) -> dict:
    stats = server.event_stats()
    return {m: stats.get(m, {}).get("count", 0) for m in methods}


def _dag_start(torch, ray, card: str) -> dict:
    """Phase 19's setup: seed-0 GPT-2-small put once, both actors
    started at once, and the driver's reference work done while they
    start."""
    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_forward, init_gpt2
    from ray_tpu_torch.util import collective as col
    from ray_tpu_torch.util import tree

    cfg = GPT2Config.small()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_gpt2(gen, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params_ref = ray.put(params)
    put_s = time.perf_counter() - t0
    # rank 1 may restart once (part c)
    Stage = ray.remote(num_gpus=DAG_GPU_SHARE)(DagStage)
    submitted = time.time()
    stages = [Stage.remote([params_ref], 0),
              Stage.options(max_restarts=1).remote([params_ref], 1)]
    # the group's coordinator as init_collective_group makes it, started
    # with the actors (a call to an actor waits until it is up, so the
    # calls come after the driver's reference work)
    coord = ray.remote(num_cpus=0)(col._Rendezvous).options(
        name=f"__collective_{DAG_GROUP}", get_if_exists=True,
        max_concurrency=4).remote(2)
    t0 = time.perf_counter()
    tgen = torch.Generator(device="cuda")
    tgen.manual_seed(DAG_SEED)
    B, T = DAG_BATCH
    inputs = [torch.randint(0, cfg.vocab_size, (B, T), generator=tgen,
                            device="cuda") for _ in range(DAG_EXECS + 1)]
    with torch.no_grad():
        ref_logits = [gpt2_forward(params, x, cfg)[:, -1]
                      for x in inputs[1:]]
    g0, loss0 = _lm_grads(params, _dp_batch(torch, cfg.vocab_size, 0), cfg)
    g1, loss1 = _lm_grads(params, _dp_batch(torch, cfg.vocab_size, 1), cfg)
    avg = tree.unflatten(g0, [(a + b) * 0.5 for a, b in
                              zip(tree.leaves(g0), tree.leaves(g1))])
    del g0, g1
    torch.cuda.synchronize()
    avg_ref = ray.put(avg)
    del avg
    want_sum = _param_checksum(params)
    ref_s = time.perf_counter() - t0
    # one tensor to a mailbox slot no rank reads: torch's import in the
    # coordinator runs beside the rest of the actors' start
    coord_ref = coord.send.remote(-1, -1, 0, torch.zeros(1))
    info_refs = [s.info.remote() for s in stages]
    warm_refs = [s.warm.remote() for s in stages]
    infos = ray.get(info_refs, timeout=DAG_WAIT_S)
    ready_s = time.time() - submitted
    warm_s = ray.get(warm_refs, timeout=DAG_WAIT_S)
    ray.get(coord_ref, timeout=DAG_WAIT_S)
    warmed_s = time.time() - submitted
    for i in infos:
        if i["checksum"] != want_sum:
            fail(f"dag_gpt2: rank {i['rank']}'s params differ from the "
                 f"driver's seed-0 GPT-2-small")
    if infos[0]["pid"] == infos[1]["pid"]:
        fail(f"dag_gpt2: both ranks run in process {infos[0]['pid']}")
    emit({"phase": "dag_gpt2_start", "card": card, "params_put_s": put_s,
          "driver_reference_s": ref_s, "actors_ready_s": ready_s,
          "warm_s": warm_s, "warmed_and_coordinator_ready_s": warmed_s,
          "start_split": [dict(_start_split(i["start"], submitted),
                               params_get=i["start"]["params_ready"]
                               - i["start"]["cuda_ready"])
                          for i in infos]})
    with torch.no_grad():
        act = _dag_stage(params, cfg, inputs[1], 0)
    return {"cfg": cfg, "params_ref": params_ref, "stages": stages,
            "infos": infos, "inputs": inputs, "ref_logits": ref_logits,
            "act": act, "avg_ref": avg_ref,
            "losses": [float(loss0), float(loss1)]}


def _dag_pipeline(torch, ray, c, card: str, st: dict, slots: list) -> dict:
    """Phase 19 (a): the compiled two-stage forward against the eager
    chain and gpt2_forward. Returns the outputs and each stage's
    launches over the timed executions."""
    from ray_tpu_torch.dag import InputNode

    cfg, (s0, s1), inputs = st["cfg"], st["stages"], st["inputs"]
    B, T = DAG_BATCH
    with InputNode() as inp:
        st["out_node"] = s1.stage1.bind(s0.stage0.bind(inp))
    st["cap"] = DAG_CHANNEL_MSGS * B * T * cfg.n_embd * 4
    counts0 = _dag_counts()
    t0 = time.perf_counter()
    dag = st["out_node"].compile(channel_capacity=st["cap"])
    compile_s = time.perf_counter() - t0
    slots.extend(ch.name for ch in dag._channels)
    t0 = time.perf_counter()
    dag.execute(inputs[0]).get(timeout=DAG_WAIT_S)
    warm_s = time.perf_counter() - t0
    ray.get([s.reset_counters.remote() for s in st["stages"]],
            timeout=DAG_WAIT_S)
    head0 = _rpc_counts(c.head.server, HEAD_RPCS)
    node0 = _rpc_counts(c.nodelets[0].server, NODELET_RPCS)
    t0 = time.perf_counter()
    refs = [dag.execute(x) for x in inputs[1:]]
    compiled = [r.get(timeout=DAG_WAIT_S) for r in refs]
    torch.cuda.synchronize()
    compiled_s = time.perf_counter() - t0
    head1 = _rpc_counts(c.head.server, HEAD_RPCS)
    node1 = _rpc_counts(c.nodelets[0].server, NODELET_RPCS)
    launches = ray.get([s.launches.remote() for s in st["stages"]],
                       timeout=DAG_WAIT_S)
    execs = {k: v - counts0[k] for k, v in _dag_counts().items()}
    if head1 != head0 or node1 != node0:
        fail(f"dag_gpt2: scheduling RPCs during the compiled executions: "
             f"head {head0} -> {head1}, nodelet {node0} -> {node1}")
    if execs != {"compiled": DAG_EXECS + 1, "eager_fallback": 0}:
        fail(f"dag_gpt2: dag_executions_total moved by {execs}, want "
             f"{DAG_EXECS + 1} compiled and 0 eager_fallback")
    for rank, n in enumerate((DAG_SPLIT, cfg.n_layer - DAG_SPLIT)):
        want = {"flash_fwd": n * DAG_EXECS, "flash_dq": 0, "flash_dkv": 0,
                "paged_attention": 0}
        if {k: launches[rank][k] for k in want} != want:
            fail(f"dag_gpt2: stage {rank} launched {launches[rank]} over "
                 f"{DAG_EXECS} executions, want {want}")
    lat_compiled = []
    for x in inputs[1:1 + DAG_LATENCY_RUNS]:
        t1 = time.perf_counter()
        dag.execute(x).get(timeout=DAG_WAIT_S)
        lat_compiled.append(time.perf_counter() - t1)
    dag.teardown()
    # the eager chain of the same stages on the same inputs
    t0 = time.perf_counter()
    eager = ray.get([s1.stage1.remote(s0.stage0.remote(x))
                     for x in inputs[1:]], timeout=DAG_WAIT_S)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    lat_eager = []
    for x in inputs[1:1 + DAG_LATENCY_RUNS]:
        t1 = time.perf_counter()
        ray.get(s1.stage1.remote(s0.stage0.remote(x)), timeout=DAG_WAIT_S)
        lat_eager.append(time.perf_counter() - t1)
    stage_ms = ray.get([s0.time_stage.remote(inputs[1], 0, 10),
                        s1.time_stage.remote(st.pop("act"), 1, 10)],
                       timeout=DAG_WAIT_S)
    worst, worst_mean = 0.0, 0.0
    for i, (a, e, r) in enumerate(zip(compiled, eager, st["ref_logits"])):
        if not (a.is_cuda and a.shape == (B, cfg.padded_vocab)
                and torch.equal(a, e)):
            fail(f"dag_gpt2: execution {i}'s logits ({a.dtype} "
                 f"{tuple(a.shape)} on {a.device}) differ from the eager "
                 f"chain's")
        d = (a - r).abs()
        worst = max(worst, d.max().item())
        worst_mean = max(worst_mean, d.mean().item())
    if not (worst <= LOGITS_TOL["max_abs"]
            and worst_mean <= LOGITS_TOL["mean_abs"]):
        fail(f"dag_gpt2: the stages' logits differ from gpt2_forward's by "
             f"{worst} max, {worst_mean} mean (tol {LOGITS_TOL})")
    emit({"phase": "dag_gpt2_pipeline", "card": card,
          "batch": list(DAG_BATCH), "split": DAG_SPLIT,
          "executions": DAG_EXECS, "channel_capacity": st["cap"],
          "compile_s": compile_s, "warm_execution_s": warm_s,
          "compiled_s": compiled_s,
          "compiled_exec_per_s": DAG_EXECS / compiled_s,
          "eager_s": eager_s, "eager_exec_per_s": DAG_EXECS / eager_s,
          "latency_ms": {
              "compiled": spread([x * 1e3 for x in lat_compiled]),
              "eager": spread([x * 1e3 for x in lat_eager])},
          "stage_compute_ms": stage_ms,
          "bitwise_equal_to_eager": True,
          "max_abs_vs_gpt2_forward": worst,
          "mean_abs_vs_gpt2_forward": worst_mean,
          "dag_executions_total": execs,
          "head_rpcs_during": {k: head1[k] - head0[k] for k in head0},
          "nodelet_rpcs_during": {k: node1[k] - node0[k] for k in node0},
          "stage_launches": launches})
    return {"compiled": compiled, "launches": launches}


def _dag_data_parallel(torch, ray, card: str, st: dict) -> list:
    """Phase 19 (b): the data-parallel step through the host collective,
    then send/recv and a ShmCommunicator. Returns each rank's launches
    over its grads."""
    cfg, stages = st["cfg"], st["stages"]
    t0 = time.perf_counter()
    join_s = ray.get([s.join.remote() for s in stages], timeout=DAG_WAIT_S)
    avg_ref = st.pop("avg_ref")
    dp = ray.get([s.dp_step.remote([avg_ref]) for s in stages],
                 timeout=DAG_WAIT_S)
    del avg_ref
    L = cfg.n_layer
    want = {"flash_fwd": 2 * L, "flash_dq": L, "flash_dkv": L,
            "paged_attention": 0}
    for rank, r in enumerate(dp):
        if {k: r["launches"][k] for k in want} != want:
            fail(f"dag_gpt2: rank {rank}'s grads launched {r['launches']}, "
                 f"want {want}")
        if r["avg_placed"] != [("Tensor", "cuda:0")] or not r["avg_equal"]:
            fail(f"dag_gpt2: rank {rank}'s averaged grads ({r['avg_placed']}"
                 f") differ from the driver's (g0 + g1) * 0.5 by "
                 f"{r['avg_max_diff']}")
        if not r["broadcast_equal"] or r["broadcast_on"] != ["cuda:0"]:
            fail(f"dag_gpt2: rank {rank}'s broadcast params on "
                 f"{r['broadcast_on']} differ from rank 0's")
        if r["losses"] != st["losses"] or r["losses_on"] != ["cuda:0"]:
            fail(f"dag_gpt2: rank {rank} gathered {r['losses']} on "
                 f"{r['losses_on']}, the driver's losses are "
                 f"{st['losses']}")
    comm_name = f"{DAG_GROUP}_{os.getpid()}"
    for s in stages:  # rank 0 makes the rings first
        ray.get(s.make_comm.remote(comm_name), timeout=DAG_WAIT_S)
    sr = ray.get([s.send_recv.remote() for s in stages], timeout=DAG_WAIT_S)
    for how in ("collective", "channel"):
        if not sr[1][how]["equal"]:
            fail(f"dag_gpt2: the {DAG_SEND_BYTES}-byte tensor through the "
                 f"{how} differs from what rank 0 sent")
    if sr[1]["channel"]["arrived_on"] != "cuda:0":
        fail(f"dag_gpt2: the channel's tensor arrived on "
             f"{sr[1]['channel']['arrived_on']}, not the card")
    emit({"phase": "dag_gpt2_data_parallel", "card": card,
          "batch": list(TRAIN_BATCH), "join_s": join_s,
          "grad_s": [r["grad_s"] for r in dp],
          "launches": [r["launches"] for r in dp],
          "grad_bytes": dp[0]["grad_bytes"],
          "allreduce_s": [r["allreduce_s"] for r in dp],
          "allreduce_gbps": [r["grad_bytes"] / r["allreduce_s"] / 1e9
                             for r in dp],
          "broadcast_s": [r["broadcast_s"] for r in dp],
          "averaged_grads_bitwise_equal_to_driver": True,
          "losses": dp[0]["losses"],
          "collective_seconds_by_op": [x["collective_seconds"] for x in sr],
          "send_bytes": DAG_SEND_BYTES,
          "send_recv": {how: {"recv_s": sr[1][how]["s"],
                              "gbps": sr[1][how]["gbps"],
                              "arrived_on": sr[1][how]["arrived_on"],
                              "send_s": sr[0][how]["s"]}
                        for how in ("collective", "channel")},
          "part_s": time.perf_counter() - t0})
    return [r["launches"] for r in dp]


def _dag_kill(torch, ray, card: str, st: dict, compiled: list,
              slots: list) -> None:
    """Phase 19 (c): the pipeline compiled again, DAG_KILL_EXECS
    executions submitted and rank 1's process killed while they are in
    flight."""
    import signal

    from ray_tpu_torch.core.api import _global_runtime

    rt = _global_runtime()
    s1, infos = st["stages"][1], st["infos"]

    def head_view() -> tuple:
        r = rt.client.call(rt.head_address, "get_actor",
                           {"actor_id": s1._actor_id.binary(),
                            "wait": False}, timeout=10)
        return r.get("state"), r.get("address")

    old_address = head_view()[1]
    dag = st["out_node"].compile(channel_capacity=st["cap"])
    slots_c = [ch.name for ch in dag._channels]
    slots.extend(slots_c)
    counts0 = _dag_counts()
    refs = [dag.execute(x) for x in st["inputs"][1:1 + DAG_KILL_EXECS]]
    t_kill, killed_at = time.perf_counter(), time.time()
    os.kill(infos[1]["pid"], signal.SIGKILL)
    # the JAX restartable-stage scenario's settle barrier: the head
    # shows the new incarnation before the results are read, so the
    # drain's first liveness probe sees the new address
    deadline = time.monotonic() + DAG_WAIT_S
    while True:
        state, address = head_view()
        if state == "ALIVE" and address != old_address:
            break
        if time.monotonic() > deadline:
            fail(f"dag_gpt2: rank 1 did not come back within {DAG_WAIT_S} s")
        time.sleep(0.1)
    settled_s = time.perf_counter() - t_kill
    after = [r.get(timeout=DAG_WAIT_S) for r in refs]
    kill_s = time.perf_counter() - t_kill
    execs = {k: v - counts0[k] for k, v in _dag_counts().items()}
    dag.teardown()
    left = [n for n in slots_c if os.path.exists(os.path.join("/dev/shm", n))]
    if left:
        fail(f"dag_gpt2: channel slots {left} outlived teardown()")
    for i, (a, b) in enumerate(zip(after, compiled)):
        if not (a.is_cuda and torch.equal(a, b)):
            fail(f"dag_gpt2: execution {i} through the kill differs from "
                 f"part (a)'s")
    if execs["eager_fallback"] < 1:
        fail(f"dag_gpt2: no execution took the eager fallback ({execs})")
    info1 = ray.get(s1.info.remote(), timeout=DAG_WAIT_S)
    restarted = ray.get(s1.launches.remote(), timeout=DAG_WAIT_S)
    if info1["pid"] == infos[1]["pid"] or restarted["flash_fwd"] < 1:
        fail(f"dag_gpt2: rank 1 after the kill is process {info1['pid']} "
             f"(was {infos[1]['pid']}) with launches {restarted}")
    emit({"phase": "dag_gpt2_kill", "card": card,
          "executions": DAG_KILL_EXECS, "dag_executions_total": execs,
          "kill_to_restarted_s": settled_s,
          "kill_to_last_result_s": kill_s,
          "killed_pid": infos[1]["pid"], "restarted_pid": info1["pid"],
          "restart_split": _start_split(info1["start"], killed_at),
          "restarted_launches": restarted,
          "results_equal_to_part_a": True})


# ------------------------------------------------------------ phase 20


def _spans_since(log, n0: int, prefix: str) -> list[dict]:
    return [e for e in log.chrome_trace()[n0:]
            if e.get("ph") == "X" and e.get("name", "").startswith(prefix)]


def _slo_counts(text: str) -> dict:
    """The SLO histograms' observation counts on a Prometheus page: TTFT's
    whole (its ``phase="total"`` series) and TPOT's."""
    out = {}
    for line in text.splitlines():
        name = line.split("{", 1)[0]
        if name == "serve_slo_tpot_ms_count" or (
                name == "serve_slo_ttft_ms_count"
                and 'phase="total"' in line):
            out[name] = out.get(name, 0.0) + float(line.split()[-1])
    return out


def _observe_serve(torch, card: str) -> dict:
    """Phase 20 (a): phase 3's GPT-2-small requests through an engine at
    the JAX engine's defaults but for the paged decode (K4), submitted
    under one span; returns the launches."""
    from ray_tpu_torch.serve.llm import EngineConfig, LLMEngine
    from ray_tpu_torch.util import tracing
    from ray_tpu_torch.util.metrics import prometheus_text

    t0 = time.perf_counter()
    engine = LLMEngine(EngineConfig(model="gpt2", preset="small",
                                    max_model_len=1024, seed=0,
                                    use_paged_attention=True))
    init_s = time.perf_counter() - t0
    prompts = engine_prompts(engine.model_cfg.vocab_size, 0)
    _, log = tracing._ctx_and_log()
    n0 = len(log.chrome_trace())
    slo0 = _slo_counts(prometheus_text())
    counters = _reset_counters()
    with tracing.span("observe_gpt2.serve") as root:
        run = serve(torch, engine, prompts, MAX_TOKENS)
    launches = launch_counts(counters)
    check_drained(engine, "observe_gpt2")
    L, chunk = engine.model_cfg.n_layer, engine.runner.prefill_chunk_size
    del engine
    release(torch)
    # K1 runs a monolithic prefill (a prompt of at most one chunk), K4
    # each decode step (the engine's step histogram counts them), once a
    # layer
    decodes = run["step_ms"].get("decode", {}).get("n", 0)
    mono = sum(1 for p in prompts if len(p) <= chunk)
    want = {"flash_fwd": mono * L, "paged_attention": decodes * L}
    if decodes <= 0 or {k: launches[k] for k in want} != want:
        fail(f"observe_gpt2: the traced engine launched {launches}, want "
             f"{want} ({mono} monolithic prefills, {decodes} decode steps "
             f"of {L} layers)")
    worst = 0.0
    for f in run["finals"]:
        bd = f["breakdown"]
        gap = abs(sum(v for k, v in bd.items() if k != "e2e") - bd["e2e"])
        worst = max(worst, gap / bd["e2e"])
    if worst > 0.05:
        fail(f"observe_gpt2: a request's breakdown misses its e2e by "
             f"{worst:.1%} (the JAX bar is 5 %)")
    spans = _spans_since(log, n0, "llm.request")
    reqs = [e for e in spans if e["name"] == "llm.request"
            and e["args"].get("trace_id") == root["trace_id"]]
    if len(reqs) != len(prompts):
        fail(f"observe_gpt2: {len(reqs)} llm.request spans under the "
             f"root trace, want {len(prompts)}")
    kids = {}
    for e in spans:
        if e["name"].startswith("llm.request."):
            kids.setdefault(e["args"].get("parent_id"), set()).add(
                e["name"].split(".", 2)[2])
    for e in reqs:
        phases = kids.get(e["args"]["span_id"], set())
        if not {"prefill", "decode"} <= phases:
            fail(f"observe_gpt2: a request's phase children are "
                 f"{sorted(phases)}, want prefill and decode among them")
    slo = {k: v - slo0.get(k, 0.0)
           for k, v in _slo_counts(prometheus_text()).items()}
    if slo != {"serve_slo_ttft_ms_count": len(prompts),
               "serve_slo_tpot_ms_count": len(prompts)}:
        fail(f"observe_gpt2: the SLO histograms took {slo} observations "
             f"of the {len(prompts)} requests")
    return {"launches": launches, "init_s": init_s,
            "decode_steps": decodes, "monolithic_prefills": mono,
            "tokens_per_s": run["tokens_per_s"],
            "ttft_ms_p50": run["ttft_ms_p50"],
            "breakdown_worst_gap": worst, "request_spans": len(reqs),
            "slo_counts": slo}


def _trace_holds_launches(phase: str, path: str, launches: dict) -> dict:
    """K1-K3's kernel events in the chrome trace at `path`; fail unless
    there is one a launch (`launches`). ``profiler_capture`` has already
    raised on fewer; this also fails on more."""
    from ray_tpu_torch.util import tracing

    events = tracing.kernel_events(path)
    device = {k: events[k] for k in OBSERVE_KERNELS}
    want = {k: launches[k] for k in OBSERVE_KERNELS}
    if device != want:
        fail(f"{phase}: the chrome trace {path} holds device events "
             f"{device}, want one a launch: {want}")
    return device


def _observe_train(torch, train: tuple) -> dict:
    """Phase 20 (b): train's step, state and batch (`train`, left by the
    train phase), OBSERVE_TRAIN_STEPS more steps with the step waterfall
    on inside ``tracing.profiler_capture(..., device="cuda")``; returns
    the launches."""
    import shutil

    from ray_tpu_torch.train import spmd
    from ray_tpu_torch.util import tracing

    step, state, batch = train
    del train
    shutil.rmtree(OBSERVE_DIR, ignore_errors=True)
    _, log = tracing._ctx_and_log()
    n0 = len(log.chrome_trace())
    counters = _reset_counters()
    spmd.waterfall.reset()
    spmd.enable_step_waterfall()
    host_s = []
    try:
        with tracing.profiler_capture(OBSERVE_DIR, device="cuda") as path:
            t_first = time.perf_counter()
            for _ in range(OBSERVE_TRAIN_STEPS):
                t0 = time.perf_counter()
                state, _ = step(state, batch)
                host_s.append(time.perf_counter() - t0)
            wall = time.perf_counter() - t_first
        export_s = time.perf_counter() - t_first - wall
    except RuntimeError as e:
        fail(f"observe_gpt2: {e}")
    finally:
        spmd.enable_step_waterfall(False)
    launches = launch_counts(counters)
    del state
    want = {"flash_fwd": 24 * OBSERVE_TRAIN_STEPS,
            "flash_dq": 12 * OBSERVE_TRAIN_STEPS,
            "flash_dkv": 12 * OBSERVE_TRAIN_STEPS, "paged_attention": 0}
    if {k: launches[k] for k in want} != want:
        fail(f"observe_gpt2: the traced steps launched {launches}, want "
             f"{want}")
    summ = spmd.waterfall.summary()
    if summ["steps"] != OBSERVE_TRAIN_STEPS \
            or abs(summ["total_seconds"] - wall) > 0.05 * wall:
        fail(f"observe_gpt2: the waterfall's {summ['steps']} steps hold "
             f"{summ['total_seconds']} s of the steps' {wall} s")
    spans = _spans_since(log, n0, "train.step.")
    per_step = [0.0] * OBSERVE_TRAIN_STEPS
    i = -1
    for e in sorted(spans, key=lambda e: e["ts"]):
        if e["name"] == "train.step.h2d" or i < 0:
            i += 1
        if i >= OBSERVE_TRAIN_STEPS:
            break
        per_step[i] += e["dur"] / 1e6
    gaps = [abs(a - b) / b for a, b in zip(per_step, host_s)]
    if len(spans) < 2 * OBSERVE_TRAIN_STEPS or max(gaps) > 0.05:
        fail(f"observe_gpt2: the train.step.* spans ({len(spans)}) sum to "
             f"{per_step} s a step against the steps' {host_s} s")
    device = _trace_holds_launches("observe_gpt2", path, launches)
    return {"launches": launches, "step_host_s": host_s,
            "step_span_s": per_step, "worst_span_gap": max(gaps),
            "waterfall": summ["phases"], "trace_file": path,
            "trace_bytes": os.path.getsize(path), "export_s": export_s,
            "device_events": device}


def phase_observe_gpt2(torch, card: str, train: tuple) -> tuple:
    """Phase 20 (a) and (b), on the driver, (b) on the train phase's
    step, state and batch (`train`); part (c) runs on phase 19's cluster
    (`_observe_cluster`) and prints the phase's line. Returns the
    launches of (a) and (b) and their results, which (c) takes."""
    t0 = time.perf_counter()
    serve_part = _observe_serve(torch, card)
    t1 = time.perf_counter()
    train_part = _observe_train(torch, train)
    del train
    release(torch)
    result = {"serve": serve_part, "train": train_part,
              "serve_s": t1 - t0, "train_s": time.perf_counter() - t1}
    return _add_launches(dict(serve_part["launches"]),
                         train_part["launches"]), result


def _poll(fn, what: str):
    deadline = time.monotonic() + OBSERVE_POLL_S
    while True:
        got = fn()
        if got:
            return got
        if time.monotonic() > deadline:
            fail(f"observe_gpt2: {what} within {OBSERVE_POLL_S} s")
        time.sleep(0.25)


def _observe_cluster(torch, ray, c, card: str, st: dict,
                     result: dict) -> dict:
    """Phase 20 (c), on phase 19's cluster with its rank-0 actor (no new
    card process): the span chain, the metrics page and its HTTP face,
    the log plane, the profiler, a Watchtower rule and a debug dump.
    Prints the phase's line; returns the actor's launches."""
    import urllib.request

    from ray_tpu_torch.util import state as sapi
    from ray_tpu_torch.util import tracing

    t0 = time.perf_counter()
    stage = st["stages"][0]
    nid = c.nodelets[0].node_id.hex()[:12]
    checks = {}
    with tracing.span("observe_gpt2.cluster") as root:
        chain = ray.get(stage.observe_chain.remote(), timeout=DAG_WAIT_S)
    tid = root["trace_id"]
    if chain["actor"]["trace_id"] != tid or chain["leaf"]["trace_id"] != tid:
        fail(f"observe_gpt2: the actor ran under {chain['actor']} and its "
             f"task under {chain['leaf']}, the driver's span is {root}")

    def chain_spans():
        names = {e["name"] for e in ray.timeline() if e.get("ph") == "X"
                 and e.get("args", {}).get("trace_id") == tid}
        actor = any(n.endswith(".observe_chain") for n in names)
        want = {"observe_gpt2.cluster", "_observe_leaf"}
        return names if actor and want <= names else None

    _poll(chain_spans, "the span chain on the merged timeline")
    if chain["pid"] == os.getpid():
        fail("observe_gpt2: the actor ran in the driver's process")
    checks["span_chain_one_trace"] = True

    quiet = [a for a in sapi.alerts()["alerts"]
             if a["rule"] == OBSERVE_RULE and a["state"] != "resolved"]
    ray.get(stage.reset_counters.remote(), timeout=DAG_WAIT_S)
    loop_ref = stage.observe_train.remote(OBSERVE_LOOP_S)
    time.sleep(0.5)
    prof = sapi.profile(duration_s=OBSERVE_PROFILE_S)
    loop = ray.get(loop_ref, timeout=DAG_WAIT_S)
    launches = ray.get(stage.launches.remote(), timeout=DAG_WAIT_S)
    n = loop["steps"]
    want = {"flash_fwd": 24 * n, "flash_dq": 12 * n, "flash_dkv": 12 * n,
            "paged_attention": 0}
    if {k: launches[k] for k in want} != want \
            or not all(math.isfinite(x) for x in loop["losses"]):
        fail(f"observe_gpt2: the actor's {n} steps launched {launches} "
             f"(want {want}), losses {loop['losses']}")
    looped = [k for k in prof["stacks"] if ":_observe_loop" in k]
    if prof["errors"] or not looped \
            or not all(k.startswith(f"node:{nid};proc:") for k in looped):
        fail(f"observe_gpt2: the profile ({prof['samples']} samples, "
             f"errors {prof['errors']}) names the actor's loop in "
             f"{len(looped)} stacks")
    checks["profile_names_the_loop"] = True

    def step_series(text):
        return [ln for ln in text.splitlines()
                if ln.startswith("train_step_seconds_count{")
                and f'node="{nid}"' in ln and float(ln.split()[-1]) >= n]

    series = step_series(sapi.cluster_metrics())
    if not series:
        fail(f"observe_gpt2: no train_step_seconds of node {nid} with "
             f">= {n} steps on the cluster metrics page")
    checks["cluster_metrics_by_node"] = True
    port = c.head.start_metrics_http(0)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        if not step_series(r.read().decode()):
            fail("observe_gpt2: the /metrics page over HTTP lacks the "
                 "actor's train_step_seconds")
    checks["metrics_http"] = True

    def traced_logs():
        recs = sapi.cluster_logs(trace_id=tid)["records"]
        got = {r.get("source"): r.get("msg", "") for r in recs}
        return got if {"stdout", "log"} <= set(got) else None

    logs = _poll(traced_logs, "the actor's print and log by trace id")
    if logs["stdout"] != f"observe_gpt2 print {tid}" \
            or logs["log"] != f"observe_gpt2 log {tid}":
        fail(f"observe_gpt2: the log plane returned {logs}")
    checks["logs_by_trace_id"] = True

    def fired():
        return [a for a in sapi.alerts()["alerts"]
                if a["rule"] == OBSERVE_RULE and a["state"] == "firing"]

    if quiet:
        fail(f"observe_gpt2: the rule {OBSERVE_RULE} fired before the "
             f"actor trained: {quiet}")
    firing = _poll(fired, f"the rule {OBSERVE_RULE} firing")
    checks["threshold_rule_fires"] = True

    out_dir = sapi.debug_dump(out_dir=os.path.join(OBSERVE_DIR, "dump"),
                              deadline_s=30)
    with open(os.path.join(out_dir, "summary.json")) as f:
        summary = json.load(f)
    every = {"nodes", "actors", "tasks", "task_ledger", "placement_groups",
             "objects", "memory", "metrics", "alerts", "timeline",
             "cluster_logs", "profile", "serve_status"}
    if summary["errors"] or not every <= set(summary["artifacts"]):
        fail(f"observe_gpt2: the debug dump wrote "
             f"{sorted(summary['artifacts'])} with errors "
             f"{summary['errors']}")
    checks["debug_dump_every_artifact"] = True
    cluster_s = time.perf_counter() - t0

    checks.update(serve_spans_breakdown_slo_k1_k4=True,
                  train_spans_waterfall_trace_k1_k3=True)
    seconds = {"serve": result["serve_s"], "train": result["train_s"],
               "cluster": cluster_s}
    emit({"phase": "observe_gpt2", "card": card, "part_s": seconds,
          "phase_s": sum(seconds.values()),
          "budget_s": OBSERVE_BUDGET_S, "checks": checks,
          "serve": {k: v for k, v in result["serve"].items()
                    if k != "launches"},
          "train": {k: v for k, v in result["train"].items()
                    if k != "launches"},
          "cluster": {"actor_steps": n, "actor_launches": launches,
                      "profile_samples": prof["samples"],
                      "loop_stacks": len(looped),
                      "rule_p50_step_s": firing[0]["value"],
                      "metrics_series": series,
                      "dump_artifacts": summary["artifacts"]}})
    return launches


def _dag_cluster(torch):
    """Phase 19's cluster: one node with the card and DAG_STORE_BYTES of
    store. Its head's Watchtower carries phase 20 (c)'s threshold rule
    OBSERVE_RULE: the median train step observed on the cluster page
    over the last OBSERVE_RULE_WINDOW_S, which exists only while train
    steps land (the driver's own steps, on the head's page, ended before
    the cluster started; only phase 20's loop trains on it)."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.core.head import Head
    from ray_tpu_torch.util.watchtower import WatchRule, default_rules

    rule = WatchRule(OBSERVE_RULE, metric="train_step_seconds",
                     stat="p50", op=">", threshold=0.0,
                     window_s=OBSERVE_RULE_WINDOW_S, severity="info",
                     description="phase 20: train steps landed on the "
                                 "cluster page")
    c = Cluster(initialize_head=False)
    c.head = Head(session_name=os.path.basename(c.session_dir),
                  watchtower_period_s=OBSERVE_WATCH_PERIOD_S,
                  watchtower_rules=default_rules() + [rule]).start()
    c.add_node(num_cpus=os.cpu_count() or 8,
               num_gpus=torch.cuda.device_count(),
               store_capacity=DAG_STORE_BYTES)
    return c


def phase_dag_gpt2(torch, card: str, observe: dict | None = None) -> dict:
    """Phase 19: collectives, channels and compiled graphs on the cluster
    runtime with two GPT-2-small actors on the card (see the docstring);
    returns the launches of the path dag_gpt2 under its name. With
    `observe` (phase 20's (a) and (b) results) phase 20's part (c) runs
    on this cluster before its shutdown, and its launches come back
    under ``observe_gpt2``."""
    import ray_tpu_torch as ray
    from ray_tpu_torch.core import object_store

    t_phase = time.perf_counter()
    release(torch)
    c = _dag_cluster(torch)
    stores = [c.nodelets[0].store.name]
    seen_pids: set = set()
    slots: list = []
    parts: dict = {}
    paths: dict = {}
    t_part = [time.perf_counter()]

    def part(name: str) -> None:
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    try:
        c.wait_for_nodes()
        ray.init(address=c.address)
        part("cluster")
        st = _dag_start(torch, ray, card)
        seen_pids.update(i["pid"] for i in st["infos"])
        part("start")
        pipe = _dag_pipeline(torch, ray, c, card, st, slots)
        part("pipeline")
        dp = _dag_data_parallel(torch, ray, card, st)
        part("data_parallel")
        _dag_kill(torch, ray, card, st, pipe["compiled"], slots)
        part("kill")
        if observe is not None:
            paths["observe_gpt2"] = _observe_cluster(torch, ray, c, card, st,
                                                     observe)
            part("observe_gpt2")
        seen_pids.update(_node_workers(ray, c.nodelets))
        for s in st["stages"]:
            ray.kill(s)
        del st
    finally:
        ray.shutdown()
        c.shutdown()
    release(torch)
    part("shutdown")
    left = [s for s in stores + slots
            if os.path.exists(os.path.join(object_store._SHM_DIR, s))]
    if left:
        fail(f"dag_gpt2: shm segments {left} outlived shutdown()")
    alive = []
    for pid in seen_pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    if alive:
        fail(f"dag_gpt2: worker processes {alive} outlived shutdown()")
    launches = {k: sum(r[k] for r in dp) for k in dp[0]
                if k != "paged_attention_by_shape"}
    launches["flash_fwd"] += sum(r["flash_fwd"] for r in pipe["launches"])
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "dag_gpt2", "card": card, "launches": launches,
          "worker_pids_checked": len(seen_pids), "phase_s": phase_s,
          "parts_s": parts, "budget_s": DAG_BUDGET_S,
          "within_budget": phase_s <= DAG_BUDGET_S})
    return {"dag_gpt2": launches, **paths}


# tools_gpt2 (phase 21): the cluster tools. `launcher.up` boots
# TOOLS_CLUSTER (a head of TOOLS_HEAD_CPUS CPUs, a "gpu" type of one CPU
# and one GPU, 0-1 of them) under TOOLS_DIR; a v2 Reconciler over its
# "gpu" nodes ticks every TOOLS_TICK_S and takes an idle node back after
# TOOLS_IDLE_S; the job TOOLS_JOB (chip_job.py) trains TOOLS_STEPS steps
# in the detached actor TOOLS_ACTOR (batch seed TOOLS_SEED), the
# workflow TOOLS_WF_STEPS more on a batch drawn from TOOLS_WF_SEED;
# waits are TOOLS_WAIT_S; the phase fails past TOOLS_BUDGET_S
TOOLS_CLUSTER = "tools_gpt2"
TOOLS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "tools_gpt2")
TOOLS_HEAD_CPUS = 4.0
TOOLS_TICK_S = 0.5
TOOLS_IDLE_S = 3.0
TOOLS_JOB = "tools-gpt2"
TOOLS_SLEEP_JOB = "tools-sleep"
TOOLS_ACTOR = "tools_gpt2_trainer"
TOOLS_STEPS = 3
TOOLS_SEED = 21
TOOLS_WF_STEPS = 2
TOOLS_WF_SEED = 210
TOOLS_WAIT_S = 120.0
TOOLS_BUDGET_S = 60.0


def _tools_config() -> dict:
    """Phase 21's cluster config (a dict: the card's machine may have no
    PyYAML)."""
    return {"cluster_name": TOOLS_CLUSTER, "max_workers": 1,
            "provider": {"type": "local"}, "head_node_type": "head",
            "available_node_types": {
                "head": {"resources": {"CPU": TOOLS_HEAD_CPUS},
                         "min_workers": 0, "max_workers": 0},
                "gpu": {"resources": {"CPU": 1.0, "GPU": 1.0},
                        "min_workers": 0, "max_workers": 1}},
            "initialization_commands": [], "setup_commands": []}


def _cli(*args) -> subprocess.CompletedProcess:
    """``python -m ray_tpu_torch.scripts.cli ARGS`` from the checkout."""
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *args],
        capture_output=True, text=True, timeout=TOOLS_WAIT_S,
        cwd=os.path.dirname(os.path.abspath(__file__)))


def _wf_batch(seed: int):
    """Workflow step 1 (a CPU task): a seeded (B, T + 1) batch of token
    ids for GPT-2's vocabulary, drawn with numpy."""
    B, T = TRAIN_BATCH
    return np.random.default_rng(seed).integers(0, 50257, (B, T + 1))


def _wf_train(tokens, actor: str, steps: int) -> list:
    """Workflow step 2: `steps` train steps in the named actor on
    `tokens`; the losses as host floats. The actor is looked up here, so
    no handle enters the step's id."""
    import ray_tpu_torch as ray

    a = ray.get_actor(actor)
    return ray.get(a.train.remote(steps, tokens),
                   timeout=TOOLS_WAIT_S)["losses"]


def _wf_finish(losses: list, tokens, marker: str) -> dict:
    """Workflow step 3 (max_retries=0): ends its own worker process
    until `marker` exists."""
    if not os.path.exists(marker):
        os._exit(1)
    return {"losses": losses, "tokens_sum": int(tokens.sum())}


def _tools_capture(torch) -> dict:
    """Phase 21 (a), after every RL phase: GPT-2-small's train step
    (train's recipe, batch seed TOOLS_SEED) takes OBSERVE_TRAIN_STEPS
    steps inside ``tracing.profiler_capture``, after one warm-up step;
    the trace must hold one device event a launch of K1-K3."""
    from ray_tpu_torch.models.gpt2 import GPT2Config, init_gpt2
    from ray_tpu_torch.util import tracing

    cfg = GPT2Config.small()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(TOOLS_SEED)
    state, step, batch = _gpt2_train_setup(torch, init_gpt2(gen, cfg), cfg,
                                           gen)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    counters = _reset_counters()
    t0 = time.perf_counter()
    try:
        with tracing.profiler_capture(os.path.join(TOOLS_DIR, "profile"),
                                      device="cuda") as path:
            for _ in range(OBSERVE_TRAIN_STEPS):
                state, _ = step(state, batch)
    except RuntimeError as e:
        fail(f"tools_gpt2: after the RL phases {e}")
    capture_s = time.perf_counter() - t0
    launches = launch_counts(counters)
    del state, step, batch
    release(torch)
    want = {"flash_fwd": 24 * OBSERVE_TRAIN_STEPS,
            "flash_dq": 12 * OBSERVE_TRAIN_STEPS,
            "flash_dkv": 12 * OBSERVE_TRAIN_STEPS, "paged_attention": 0}
    if {k: launches[k] for k in want} != want:
        fail(f"tools_gpt2: the captured steps launched {launches}, want "
             f"{want}")
    device = _trace_holds_launches("tools_gpt2: after the RL phases",
                                   path, launches)
    return {"launches": {k: launches[k] for k in want},
            "device_events": device,
            "all_device_events": tracing.device_events(path),
            "trace_bytes": os.path.getsize(path), "capture_s": capture_s}


def _tools_job(ray, address: str, card: str) -> dict:
    """Submit chip_job.py through the CLI, wait for it, read its line
    back; the CLI's and the dashboard's views of it."""
    from ray_tpu_torch import dashboard
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    job = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chip_job.py")
    r = _cli("submit", "--address", address, "--submission-id", TOOLS_JOB,
             "--no-wait", "--", sys.executable, job, "--address", address,
             "--actor", TOOLS_ACTOR, "--steps", str(TOOLS_STEPS),
             "--seed", str(TOOLS_SEED), "--batch", *map(str, TRAIN_BATCH))
    if r.returncode != 0 or f"submitted {TOOLS_JOB}" not in r.stdout:
        fail(f"tools_gpt2: cli submit exited {r.returncode}: {r.stdout} "
             f"{r.stderr}")
    client = JobSubmissionClient(address)
    status = client.wait_until_finished(TOOLS_JOB, timeout=TOOLS_WAIT_S)
    logs = client.get_job_logs(TOOLS_JOB)
    if status != JobStatus.SUCCEEDED:
        fail(f"tools_gpt2: the job ended {status.value}: {logs[-2000:]}")
    lines = [json.loads(x) for x in logs.splitlines()
             if x.startswith('{"job": ')]
    if len(lines) != 1:
        fail(f"tools_gpt2: the job's logs hold {len(lines)} result lines: "
             f"{logs[-2000:]}")
    out = lines[0]
    want = {"flash_fwd": 24 * TOOLS_STEPS, "flash_dq": 12 * TOOLS_STEPS,
            "flash_dkv": 12 * TOOLS_STEPS, "paged_attention": 0}
    if out["launches"] != want:
        fail(f"tools_gpt2: the job's actor launched {out['launches']}, "
             f"want {want}")
    if len(out["losses"]) != TOOLS_STEPS or \
            not all(math.isfinite(x) for x in out["losses"]):
        fail(f"tools_gpt2: the job's losses {out['losses']}")
    if out["driver_torch_loaded"] or \
            out["driver_cuda_visible_devices"] != "":
        fail(f"tools_gpt2: the job's driver loaded torch "
             f"({out['driver_torch_loaded']}) or saw the card "
             f"(CUDA_VISIBLE_DEVICES={out['driver_cuda_visible_devices']!r})")
    if out["actor_start"]["device_count"] != 1:
        fail(f"tools_gpt2: the actor sees {out['actor_start']}")
    listed = _cli("job", "list", "--address", address)
    row = f"{TOOLS_JOB}\tSUCCEEDED\t"
    if listed.returncode != 0 or not any(
            x.startswith(row) for x in listed.stdout.splitlines()):
        fail(f"tools_gpt2: cli job list: {listed.stdout} {listed.stderr}")
    st = _cli("job", "status", "--address", address, "--id", TOOLS_JOB)
    if st.returncode != 0 or st.stdout.strip() != "SUCCEEDED exit code 0":
        fail(f"tools_gpt2: cli job status: {st.stdout} {st.stderr}")
    port = dashboard.start_dashboard(address, port=0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/api/jobs",
                                    timeout=30) as resp:
            view = json.loads(resp.read())
    finally:
        dashboard.stop_dashboard()
    if not any(j["submission_id"] == TOOLS_JOB and j["status"] ==
               "SUCCEEDED" for j in view):
        fail(f"tools_gpt2: the dashboard's jobs view {view}")
    sleeper = client.submit_job(entrypoint="sleep 60",
                                submission_id=TOOLS_SLEEP_JOB)
    deadline = time.monotonic() + TOOLS_WAIT_S
    while client.get_job_status(sleeper) != JobStatus.RUNNING:
        if time.monotonic() > deadline:
            fail("tools_gpt2: the sleep job never ran")
        time.sleep(0.1)
    if not client.stop_job(sleeper):
        fail("tools_gpt2: stop_job refused the sleep job")
    stopped = client.wait_until_finished(sleeper, timeout=TOOLS_WAIT_S)
    if stopped != JobStatus.STOPPED:
        fail(f"tools_gpt2: the stopped job ended {stopped.value}")
    return {**out, "card": card, "cli_job_status": st.stdout.strip(),
            "dashboard_jobs": view, "sleep_job": stopped.value}


def _tools_workflow(ray) -> dict:
    """Run, kill and resume a three-step workflow whose second step
    trains in the job's actor."""
    from ray_tpu_torch import workflow
    from ray_tpu_torch.core.exceptions import RayTpuError

    store = os.path.join(TOOLS_DIR, "workflows")
    marker = os.path.join(TOOLS_DIR, "resume_marker")
    actor = ray.get_actor(TOOLS_ACTOR)
    make = workflow.step(_wf_batch)
    train = workflow.step(_wf_train)
    finish = workflow.step(max_retries=0)(_wf_finish)
    batch = make.step(TOOLS_WF_SEED)
    dag = finish.step(train.step(batch, TOOLS_ACTOR, TOOLS_WF_STEPS),
                      batch, marker)
    t0 = time.perf_counter()
    try:
        workflow.run(dag, workflow_id="tools", storage=store)
    except RayTpuError as e:
        raised = type(e).__name__
    else:
        fail("tools_gpt2: the workflow ran through a step that ends its "
             "worker")
    run_s = time.perf_counter() - t0
    status = workflow.get_status("tools", storage=store)
    if status != workflow.RESUMABLE:
        fail(f"tools_gpt2: the crashed workflow is {status}")
    trained = ray.get(actor.last_result.remote(), timeout=TOOLS_WAIT_S)
    want_launches = {"flash_fwd": 24 * TOOLS_WF_STEPS,
                     "flash_dq": 12 * TOOLS_WF_STEPS,
                     "flash_dkv": 12 * TOOLS_WF_STEPS, "paged_attention": 0}
    if trained is None or trained["launches"] != want_launches:
        fail(f"tools_gpt2: the workflow's train step launched "
             f"{trained and trained['launches']}, want {want_launches}")
    before = ray.get(actor.launches.remote(), timeout=TOOLS_WAIT_S)
    with open(marker, "w"):
        pass
    t1 = time.perf_counter()
    value = workflow.resume("tools", storage=store)
    resume_s = time.perf_counter() - t1
    after = ray.get(actor.launches.remote(), timeout=TOOLS_WAIT_S)
    want = {"losses": trained["losses"],
            "tokens_sum": int(_wf_batch(TOOLS_WF_SEED).sum())}
    if value != want:
        fail(f"tools_gpt2: resume returned {value}, want {want}")
    if after != before:
        fail(f"tools_gpt2: the resume ran a finished step again: the "
             f"actor's launches went {before} -> {after}")
    final = workflow.get_status("tools", storage=store)
    if final != workflow.SUCCESS:
        fail(f"tools_gpt2: the resumed workflow is {final}")
    return {"run_raised": raised, "status_after_crash": status,
            "status_after_resume": final, "losses": trained["losses"],
            "launches": trained["launches"], "run_s": run_s,
            "resume_s": resume_s, "actor_launches_across_resume":
                {"before": before, "after": after}}


def phase_tools_gpt2(torch, card: str) -> dict:
    """Phase 21: the cluster tools on a GPT-2-small job (see the
    docstring); returns the launches of the path tools_gpt2 (the
    captured steps on the driver, the job's steps and the workflow's in
    its actor)."""
    import shutil

    import ray_tpu_torch as ray
    from ray_tpu_torch import launcher
    from ray_tpu_torch.autoscaler_v2 import RAY_RUNNING, TERMINATED, Reconciler
    from ray_tpu_torch.util.placement_group import (
        PlacementGroup,
        remove_placement_group,
    )
    from ray_tpu_torch.core.ids import PlacementGroupID

    t_phase = time.perf_counter()
    parts: dict = {}
    t_part = [t_phase]

    def part(name: str) -> None:
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    capture = _tools_capture(torch)
    part("capture")
    state = launcher.up(_tools_config(), state_dir=TOOLS_DIR)
    address = state["head"]["address"]
    pids = [state["head"]["pid"]]
    rec = None
    try:
        part("up")
        provider = launcher.LaunchedNodeProvider(TOOLS_CLUSTER, "gpu",
                                                 state_dir=TOOLS_DIR)
        rec = Reconciler(address, provider, node_type="gpu", min_workers=0,
                         max_workers=1, idle_timeout_s=TOOLS_IDLE_S)
        rec.start(interval_s=TOOLS_TICK_S)
        ray.init(address=address)
        job = _tools_job(ray, address, card)
        part("job")
        gpu_nodes = launcher.load_state(TOOLS_CLUSTER, TOOLS_DIR)["workers"]
        pids += [w["pid"] for w in gpu_nodes]
        running = rec.storage.list(RAY_RUNNING)
        if len(gpu_nodes) != 1 or len(running) != 1 or \
                running[0].node_id != bytes.fromhex(
                    gpu_nodes[0]["node_id_hex"]):
            fail(f"tools_gpt2: the reconciler's gpu node: {rec.summary()}, "
                 f"launched {gpu_nodes}")
        flow = _tools_workflow(ray)
        part("workflow")
        ray.kill(ray.get_actor(TOOLS_ACTOR))
        remove_placement_group(PlacementGroup(
            PlacementGroupID(bytes.fromhex(job["pg_id"])), []))
        deadline = time.monotonic() + TOOLS_WAIT_S
        while not rec.storage.list(TERMINATED):
            if time.monotonic() > deadline:
                fail(f"tools_gpt2: the idle gpu node was never taken "
                     f"down: {rec.summary()}")
            time.sleep(0.1)
        history = [s for s, _ in rec.storage.list(TERMINATED)[0].history]
        summary = rec.summary()
        part("scale_down")
    finally:
        if rec is not None:
            rec.stop()
        ray.shutdown()
        launcher.down(TOOLS_CLUSTER, state_dir=TOOLS_DIR)
    deadline = time.monotonic() + 30
    while any(launcher.pid_alive(p) for p in pids):
        if time.monotonic() > deadline:
            fail(f"tools_gpt2: node processes {pids} outlived down()")
        time.sleep(0.1)
    part("down")
    if history != ["QUEUED", "REQUESTED", "ALLOCATED", "RAY_RUNNING",
                   "TERMINATING", "TERMINATED"] or \
            summary["launches"] != 1 or summary["terminations"] != 1:
        fail(f"tools_gpt2: the gpu node's history {history}, {summary}")
    launches = {k: job["launches"][k] + flow["launches"][k]
                + capture["launches"][k] for k in job["launches"]}
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "tools_gpt2", "card": card, "launches": launches,
          "job": {k: job[k] for k in ("losses", "launches", "placed_s",
                                      "seconds", "train_s", "actor_start",
                                      "cli_job_status", "sleep_job")},
          "capture_after_rl": capture,
          "workflow": flow, "gpu_node_history": history,
          "reconciler": summary, "phase_s": phase_s, "parts_s": parts,
          "budget_s": TOOLS_BUDGET_S,
          "within_budget": phase_s <= TOOLS_BUDGET_S})
    if phase_s > TOOLS_BUDGET_S:
        fail(f"tools_gpt2: the phase took {phase_s} s, over its bar of "
             f"{TOOLS_BUDGET_S} s")
    return launches


def _paths(t, path=""):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _paths(t[k], f"{path}/{k}")
    else:
        yield path, t


def use_bytecode_cache(root: str) -> None:
    """Let this process and every process it starts (they inherit the
    environment) keep compiled modules under the checkout's build/. A
    machine that sets PYTHONDONTWRITEBYTECODE makes each new process
    compile torch's modules from source: an import of torch took
    10.5-10.8 s that way and 5.1-5.3 s from this cache on the host of an
    NVIDIA H100 80GB HBM3."""
    cache = os.path.join(root, "build", "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = cache
    sys.dont_write_bytecode = False
    sys.pycache_prefix = cache


def _proc_table() -> dict:
    """pid -> (parent pid, state, start in seconds after boot) of every
    process /proc lists."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                rest = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        out[int(name)] = (int(rest[1]), rest[0], int(rest[19]) / tick)
    return out


def _own_processes() -> dict:
    """pid -> (parent pid, state, start) of every process this run
    started that is still there: a descendant of this process, or one
    whose environment names this process as its nodelet's (a worker's
    child left to init when its worker went)."""
    me = os.getpid()
    table = _proc_table()
    mark = f"RAY_TPU_NODELET_PID={me}".encode()
    own = set()
    for pid in table:
        if pid == me:
            continue
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                if mark in f.read().split(b"\0"):
                    own.add(pid)
        except OSError:
            pass
    children: dict = {}
    for pid, (ppid, _, _) in table.items():
        children.setdefault(ppid, []).append(pid)
    todo = list(children.get(me, []))
    while todo:
        pid = todo.pop()
        if pid not in own:
            own.add(pid)
            todo.extend(children.get(pid, []))
    return {pid: table[pid] for pid in own if pid in table}


def stop_own_processes(t_start: float) -> list:
    """List every process this run started that is still there, stop
    each (SIGKILL to it and to its process group where it leads one) and
    wait until it is gone; `t_start` is this process's start in seconds
    after boot. Fails if one is still there after 30 s."""
    import signal

    found = []
    for pid, (ppid, state, start) in sorted(_own_processes().items()):
        if state == "Z":  # gone already: reaped by its parent or init
            with contextlib.suppress(ChildProcessError):
                os.waitpid(pid, os.WNOHANG)
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            cmd = ""
        found.append({"pid": pid, "ppid": ppid, "state": state,
                      "cmd": cmd.strip()[:200],
                      "started_s_into_run": start - t_start})
        for kill in (lambda: os.killpg(pid, signal.SIGKILL)
                     if os.getpgid(pid) == pid else None,
                     lambda: os.kill(pid, signal.SIGKILL)):
            try:
                kill()
            except OSError:
                pass
    deadline = time.monotonic() + 30
    left = [f["pid"] for f in found]
    while left:
        for pid in list(left):
            try:  # a child of this process is reaped here
                os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                pass
            if not os.path.exists(f"/proc/{pid}"):
                left.remove(pid)
        if left and time.monotonic() > deadline:
            fail(f"processes {left} of this run are still there 30 s "
                 f"after SIGKILL: {found}")
        time.sleep(0.05)
    return found


def main() -> int:
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "ray_tpu_torch")):
        fail(f"no ray_tpu_torch/ beside {__file__}: run it from a checkout")
    use_bytecode_cache(root)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)

    seconds: dict = {}
    t_start = _proc_table()[os.getpid()][2]
    t_lap = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = now - t_lap[0]
        t_lap[0] = now

    card = phase_device(torch)
    lap("device_and_build")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    check_hopper(torch, gen)
    k1 = check_flash(torch, gen)
    lap("check_flash")
    k23 = check_flash_bwd(torch, gen)
    lap("check_flash_bwd")
    k4 = check_paged(torch, gen)
    lap("check_paged")
    serve_ref: dict = {}
    paged = phase_engine(torch, serve_ref)
    serve_ref.update(tokens_per_s=paged["tokens_per_s"],
                     ttft_ms_p50=paged["ttft_ms_p50"])
    lap("engine")
    ref_default, ref_llama = {}, {}
    paths = {"serve": paged["launches"],
             "serve_default": phase_engine_default(torch, paged,
                                                   ref_default),
             "serve_spec": phase_engine_spec(torch),
             "serve_llama": phase_engine_llama(torch, ref_llama)}
    lap("engine_default_spec_llama")
    paths["tiny"], paths["serve_large_pages"] = phase_tiny(torch)
    lap("tiny")
    train_keep: dict = {}
    paths["train"] = phase_train(torch, train_keep)
    lap("train")
    paths["observe_gpt2"], observe = phase_observe_gpt2(
        torch, card, train_keep.pop("observe"))
    lap("observe_gpt2")
    release(torch)
    paths["train_llama"] = phase_train_llama(torch)
    lap("train_llama")
    paths["remat"] = phase_remat(torch)
    lap("remat")
    release(torch)
    refs: dict = {"mesh": {}, "tune": {}}
    paths["mesh"] = phase_mesh(torch, refs["mesh"])
    lap("mesh")
    for model in ("gpt2", "llama"):
        phase_parity(torch, model)
    lap("parity")
    paths.update(phase_rl(torch, card))
    lap("rl")
    paths.update(phase_serve_mesh(torch, ref_default, ref_llama))
    lap("serve_mesh")
    paths["ulysses"] = phase_ulysses(torch)
    lap("ulysses")
    phase_moe(torch)
    lap("moe")
    keep_pipe: dict = {}
    phase_pipelined(torch, keep_pipe)
    lap("pipelined")
    ppo_local = phase_ppo_cartpole(torch, card)
    lap("ppo_cartpole")
    phase_ppo_pixel(torch, card)
    lap("ppo_pixel")
    phase_ppo_learner_atari(torch, card)
    lap("ppo_learner_atari")
    phase_dqn_cartpole(torch, card)
    lap("dqn_cartpole")
    phase_ppo_learners()
    lap("ppo_learners")
    paths["more_rl"] = phase_more_rl(torch, card)
    lap("more_rl")
    paths["tune"] = phase_tune_gpt2(torch, refs["tune"])
    lap("tune_gpt2")
    paths["data_gpt2"] = phase_data_gpt2(torch, card, train_keep)
    lap("data_gpt2")
    paths["offline_rl"] = phase_offline_rl(torch, card)
    lap("offline_rl")
    paths["cluster_gpt2"] = phase_cluster(torch, card, train_keep)
    lap("cluster")
    paths.update(phase_trainer_tune(torch, card, refs))
    lap("trainer_tune")
    paths["pipeline_gpt2"] = phase_pipeline_gpt2(torch, card, keep_pipe)
    lap("pipeline_gpt2")
    paths["runtime_gpu"] = phase_runtime_gpu(torch, card, ppo_local)
    lap("runtime_gpu")
    paths["serve_gpt2"] = phase_serve_gpt2(torch, card, serve_ref)
    lap("serve_gpt2")
    dag = phase_dag_gpt2(torch, card, observe)
    lap("dag_gpt2")
    paths["dag_gpt2"] = dag["dag_gpt2"]
    paths["observe_gpt2"] = _add_launches(paths["observe_gpt2"],
                                          dag["observe_gpt2"])
    paths["tools_gpt2"] = phase_tools_gpt2(torch, card)
    lap("tools_gpt2")

    # K4's rows on the serving paths, each with its launches there
    for name, path in (("decode", "serve"), ("verify", "serve_spec"),
                       ("gqa_decode", "serve_llama"),
                       ("gqa_decode", "serve_mesh_llama"),
                       ("decode_bs64", "serve_large_pages"),
                       ("decode_bs128", "serve_large_pages"),
                       ("tiny_decode", "tiny"),
                       ("tiny_gqa_decode", "tiny"),
                       ("tiny_verify", "tiny"),
                       ("tiny_gqa_verify", "tiny"),
                       ("rl_decode", "rl_paged")):
        ctx_list, (H, HK, W, _, _, _), _ = PAGED_PATH_ROWS[name]
        row = k4[name]
        by_shape = paths[path]["paged_attention_by_shape"]
        emit({"kernel": "paged_attention", "row": name,
              "shape": row["shape"], "max_abs_err": row["max_abs_err"],
              "kernel_ms": row["kernel_ms"],
              "plain_ms": row["plain_ms"], "library_ms": row["library_ms"],
              "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
              "path": path,
              "launches_at_this_width_and_heads": k4_launches(
                  by_shape, W, H, HK),
              "launches_at_this_shape": k4_launches(
                  by_shape, W, H, HK, S=len(ctx_list))})

    # K1-K3's rows on the tiny and XL-class training paths, the rl paths
    # and a dag_gpt2 pipeline stage, with the launches of the paths that
    # run them (the tiny path's launches are those of both presets, in
    # both dtypes)
    for key, name in (("tiny", "flash_fwd"), ("tiny_f32", "flash_fwd"),
                      ("train_xl", "flash_fwd"),
                      ("flash_dq_tiny", "flash_dq"),
                      ("flash_dkv_tiny", "flash_dkv"),
                      ("flash_dq_tiny_f32", "flash_dq"),
                      ("flash_dkv_tiny_f32", "flash_dkv"),
                      ("flash_dq_xl", "flash_dq"),
                      ("flash_dkv_xl", "flash_dkv"),
                      ("rl_learner", "flash_fwd"),
                      ("rl_prefill", "flash_fwd"),
                      ("rl_prefill_ragged", "flash_fwd"),
                      ("flash_dq_rl", "flash_dq"),
                      ("flash_dkv_rl", "flash_dkv"),
                      ("dag_stage", "flash_fwd")):
        row = (k1 if name == "flash_fwd" else k23)[key]
        path = ("tiny" if "tiny" in key else "rl" if "rl" in key else
                "dag_gpt2" if key == "dag_stage" else "remat")
        emit({"kernel": name, "row": key, "shape": row["shape"],
              "dtype": row["dtype"],
              "max_abs_err": row.get("max_abs_err",
                                     row.get("max_abs_err_o")),
              "kernel_ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
              "library_ms": row["library_ms"], "bound_ms": row["bound_ms"],
              "bound_by": row["bound_by"], "path": path,
              "launches_on_path": paths[path].get(name, 0)})

    # flash_fwd runs on the serving and training paths: its row is the
    # training shape, its launches those of every path
    by_path = {name: {path: launches.get(name, 0)
                      for path, launches in paths.items()}
               for name in ("flash_fwd", "flash_dq", "flash_dkv",
                            "paged_attention")}
    kernels = []
    for main_row, name, src, replaces, err_key in (
            (k1["train"], "flash_fwd",
             "ray_tpu_torch/csrc/flash_attention.cu",
             "ray_tpu/ops/flash_attention.py:60", "max_abs_err_o"),
            (k23["flash_dq"], "flash_dq",
             "ray_tpu_torch/csrc/flash_attention_bwd.cu",
             "ray_tpu/ops/flash_attention.py:151", "max_abs_err"),
            (k23["flash_dkv"], "flash_dkv",
             "ray_tpu_torch/csrc/flash_attention_bwd.cu",
             "ray_tpu/ops/flash_attention.py:192", "max_abs_err"),
            (k4["decode"], "paged_attention",
             "ray_tpu_torch/csrc/paged_attention.cu",
             "ray_tpu/ops/paged_attention.py:73", "max_abs_err")):
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_path[name].values()),
            "launches_by_path": by_path[name],
            "max_abs_err": main_row[err_key], "ms": main_row["kernel_ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "tflops": main_row["tflops"],
            "share_of_bound": main_row["share_of_bound"],
            "shape": main_row["shape"], "dtype": main_row["dtype"]})
    emit({"stray_processes": stop_own_processes(t_start)})
    emit({"phase_seconds": seconds,
          "total_s": sum(seconds.values())})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
