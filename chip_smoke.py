#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels to account.

    python3 chip_smoke.py [--out FILE.json] [--kernels-only]

Run from the repository root on a machine with a CUDA device and ``nvcc``.
It exits non-zero, and prints no result line, if there is no CUDA device,
if the package is missing, or if any phase fails. Phases:

1. device  — the card's name and power limit (``nvidia-smi``), torch version;
2. build   — compiles the CUDA sources of ``dmme_tpu_torch/ops/csrc`` in
   parallel (K1 and K2 in bf16, fp16 and f32 in ``group_norm.cu``, and at
   widths outside its domain in ``simt.cu``; K3 and K4 in bf16, fp16 and f32
   in ``attention.cu`` and ``resblock.cu``)
   and prints each
   kernel's registers and spill bytes (``-Xptxas -v``);
3. kernels — records the inputs each kernel receives at every call site of
   one full-width bf16 UNet forward at each serving batch, 1, 8 and 16 (both
   switches on; at batch 8 also ``fused_norm`` only), then holds each kernel
   against its plain PyTorch version on those inputs, with times (CUDA
   events, median of 5, of 2 for the plain versions; K4's weights are
   packed once per weight state,
   before the timed runs) and the least time the card could take; beside
   K3, SDPA; beside K4, the same ResBlock as a cuDNN sequence
   (``cudnn_seq_ms``), which the port never calls; then the split K1/K2
   entries of the ``spatial`` axis at every K1 site of an LSUN microbatch
   (bf16), at each site's channel shard of a tensor rank (C/2 channels in
   G/2 groups) and at one fp16 and f32 shape, a sample's two halves' sums
   added on the card, against their plain versions and the one-call K1/K2,
   timed on a half;
4. unet    — the full-width UNet forward on the card in bf16 under both switch
   settings against the same module and weights on the CPU in f32; then one
   forward at the LSUN widths (``configs/ddpm/lsun_*.yaml``: channels
   128/128/256/256/512/512, attention at depth 5, 256×256) at batch 1, both
   switches on, the same way, with every K1, K3 and K4 call of it (head dim
   512, 256×256 ResBlocks, a two-pass GroupNorm) held against its plain
   version;
5. serve   — ``LitDDIM`` (T=1000, DDIM-50, quadratic τ) behind ``make_server``,
   with ``/healthz`` and ``/sample`` requests of n = 1, 8 and 16, and a repeat
   that must return identical bytes; counts each kernel's launches; the
   feature-caching samplers ``cached``, ``deep`` and ``deep_dpm`` at n = 8
   (refresh interval 2: launches 1/6/22 a key forward, 1/4/14 a ``cached``
   and 1/0/5 a ``deep`` non-key one), ``edm`` and ``flow`` answered 400;
   then one request of n = 8 under ``torch.profiler``: device time by
   kernel and the device's idle share;
6. train kernels — records the inputs of K1, K2, K3 and the attention
   backward at every call site of one full-width bf16 training step at batch
   128 (dropout on, random biases and affines) and holds each against its
   plain version there, with times and bounds, and calls K1 and K2 twice
   for identical bytes; SDPA's forward and backward are timed beside K3 and
   the attention backward, ``F.group_norm`` + ``F.silu`` (and its autograd
   backward) beside K1 and K2, as yardsticks;
6b. off-path kernels — K1, K2, K3 and K4 at shapes off the main path (head
   dims 16, 48, 96, 160 and 512, a key split at a padded head dim; C_in 32
   and 96; C_out 32, 64 and 192; H×W that 64-pixel tiles of whole rows do
   not cover; C/G = 3; GroupNorms that take two passes, forward and
   backward), each held against its plain version; K1–K4 at those shapes
   in fp16 and f32 too, within ``TOL_SIMT``, each called twice for identical
   bytes;
6c. simt — K1 and K2 at widths outside ``group_norm.cu``'s domain (C = 12
   with G = 4, C = 4 with G = 2, C = 2056 with G = 8) in bf16, fp16 and f32:
   each call launches ``simt.cu`` (``simt_launches``/``simt_bwd_launches``,
   no other counter) and is held against its plain version, twice for
   identical bytes;
7. train gradient — one ``loss_given`` + backward at batch 8, dropout 0, on
   the same weights and numpy t, ε: bf16 on the card against f32 on the CPU
   (relative L2 of the loss and of the gradient, overall and per top-level
   module), every parameter's gradient finite and non-zero on the card, and
   the launches of that step: K1 45, K2 45, K3 6, K4 0;
8. fit     — ``fit(LitDDPM(dtype="bf16"), CIFAR10(synthetic=True,
   batch_size=128))`` at the recipe's settings: warm steps, one step whose
   parameter and EMA updates are checked, 20 logged steps (loss and
   grad_norm finite, launches per step), 5 steps timed with CUDA events
   (median step ms, imgs/s), and three steps under ``torch.profiler``
   (device idle share; device time by kernel, a third of theirs);
9. sample after training — a DDIM-50 n = 8 request from the trained raw
   weights through K4, equal byte for byte to the same request after K4's
   weight cache is cleared;
9b. cli — ``dmme_tpu_torch.trainer.main`` in this process (deterministic
   cuDNN): ``fit`` of ``configs/ddim/cifar10.yaml`` (synthetic data, full
   width, batch 128, bf16) for 10 steps with checkpoints at 5 and 10, JSONL,
   TensorBoard and GenerateImage grids (DDIM-50, n = 8) at 5 and 10, the
   launches 45/45/6/0 a step and 1/0/6/22 a sampling forward; a resume to 15
   against an uninterrupted 15-step run, bit for bit (parameters, EMA, Adam
   moments); ``sample`` and ``predict`` from the resumed checkpoint, predict's
   bytes equal to ``generate`` on a state restored in place after sampling
   with other weights (K4's weight cache); ``configs/ddpm/shapes_demo.yaml``
   for 20 steps in chunks of 10 (whether remat lowers the peak memory is
   held at the LSUN and ImageNet-64 widths in phases 47 and 48); the Shapes
   configs' runs render only the
   images their steps need (``SHAPES_CUT``), the configs' widths, batches
   and steps otherwise;
10. f32 and fp16 — fault C.5: ``LitDDPM()`` (f32) and ``LitDDPM(dtype="fp16")``
   each train one full-width step at batch 128 and take one DDIM step at
   n = 8 (K1/K2/K3 45/45/6 a step, K1/K3/K4 1/6/22 a forward), launching K1
   and K2 of ``group_norm.cu`` and K3 and K4 on the tensor cores in that
   dtype (f32 as 3xTF32), and no bf16 or ``simt.cu`` kernel; every call site
   held against its plain version (``TOL_SIMT``), twice for identical bytes,
   and timed beside its bounds, SDPA (K3), the cuDNN sequence (K4),
   ``F.group_norm`` + ``F.silu`` on the same inputs (K1; its autograd for
   K2) (the table's ``*_f32`` and ``*_fp16`` rows); the loss, gradient
   (dropout off, at batch ``CPU_REF_BATCH``), a UNet forward and the DDIM
   step against f32 on the CPU,
   f32 within ``F32_REL_L2`` (1e-4), fp16's forward and DDIM step within
   ``UNET_REL_L2``; the bf16 harness on the same inputs is the control that
   must miss ``F32_REL_L2``; then each harness's training step (median of
   25, device busy, idle share) and one DDIM-50 request at n = 8
   (``scripts/torch_f32_time.py``). Every bf16 path above launches no f32,
   fp16 or ``simt.cu`` kernel;
11. IDDPM kernels — the IDDPM UNet of ``configs/iddpm/cifar10.yaml`` (FiLM at
   the 22 ``norm2`` sites, 4-head attention at 11 sites, ε ‖ v output; random
   biases, affines and FiLM ``condition`` Dense): K1, K3 and K4 at every call
   site of forwards at n = 1, 8 and 16 (launches 1/11/22 a forward) and K1,
   K2, K3 and the attention backward at every call site of one training
   step at batch 128 (45/45/11/0), each held against its plain version and
   timed as in phases 3 and 6;
12. IDDPM gradient — the hybrid ``loss_given`` + backward at batch 8, T = 4000,
   one sample at t = 1, dropout 0.3 with the card's masks replayed on the
   CPU: bf16 on the card against f32 on the CPU within ``GRAD_REL_L2``, the
   variance head's gradient reported apart;
13. IDDPM fit — phase 8 for ``LitIDDPM(dtype="bf16")`` at the recipe's
   settings (launches 45/45/11/0 a step);
14. IDDPM serve — ``LitIDDPM(dtype="bf16", sample_steps=50)`` behind
   ``make_server``: ``default`` at n = 1, 8, 16 (a repeat identical),
   ``ddim``/``dpm``/``unipc`` at n = 8, ``cached`` answered 400, one request
   under the profiler, 20 steps of the T = 4000 ancestral loop; phase 5 also
   sends ``ddim``/``dpm``/``unipc`` to the DDPM model;
15. the CLI phase (9b) also runs ``configs/iddpm/shapes_demo.yaml`` for 20
   steps, ``sample --trainer.sampler dpm --trainer.sample_steps 20`` of
   ``configs/iddpm/cifar10.yaml`` and ``configs/iddpm/shapes64_demo.yaml``
   (64 px, batch 64) for 2 steps with and without remat;
16. f32 IDDPM — ``LitIDDPM()`` one step at batch 128 and one respaced step at
   n = 8 (K1/K2 on ``group_norm.cu``, K3/K4 in f32 on the tensor cores), every call
   site against its plain version; the
   loss, the gradient (the variance head included) and the step within
   ``F32_REL_L2`` of the CPU, a bf16 control missing it;
17. new call sites — K1, K3 and K4 at every call site of EDM's σ-conditioned
   forward, flow's t·1000 forward and the caching samplers' non-key
   forwards at n = 8 (launches 1/6/22, 1/6/22, 1/4/14, 1/0/5), and K1, K2, K3
   and the attention backward at every call site of one ``LitEDM`` and one
   ``LitFlow`` training step at batch 128, each held against its plain
   version (``TOL``) and timed;
18. EDM gradient — phase 7 for ``EDM.loss_given`` with σ from 0.002 to 80;
19. EDM fit — ``trainer.main fit`` of ``configs/edm/cifar10.yaml`` (synthetic
   CIFAR-10, batch 128, bf16) for 20 steps with 18-step Heun grids at 10
   and 20, launches 45/45/6/0 a step and 1/6/22 a sampling forward; then the
   saved state's train step timed (median step ms) and profiled (idle share);
20. EDM serve — ``LitEDM(dtype="bf16")`` over HTTP: ``default`` (18-step Heun,
   35 evaluations) at n = 1, 8, 16 and a repeat, ``edm`` at 10 steps; the
   other families' names answered 400; one request under the profiler;
21. flow fit and serve — phase 19 for ``configs/flow/shapes_demo.yaml`` (no
   grids) and phase 20 for ``LitFlow(dtype="bf16")``: ``default`` (25
   midpoint steps, 50 evaluations) and ``flow`` at 10 steps at n = 8;
22. f32 EDM — ``LitEDM()`` one step at batch 128 (K1/K2 on ``group_norm.cu``, K3 in
   f32 on the tensor cores); the loss
   and gradient at batch 16 (σ from 0.002 to 80) and a mid-grid Heun step
   against f32 on the CPU within ``F32_REL_L2``, a bf16 control missing it;
24. CFG kernels — the DDPM UNet with a class table (bf16, both switches):
   a guided forward at n = 1, 8, 16 is one UNet call at N = 2n (labels ‖
   the null token) with launches 1/6/22, and every K1/K3/K4 call at N = 2,
   16, 32 is held against its plain version (``TOL``) and timed; K1, K2, K3
   and the attention backward of one labelled ``LitDDPM(num_classes=2)``
   training step at batch 128;
25. CFG fit — ``trainer.main`` on ``configs/ddpm/shapes_cfg_demo.yaml``
   (full width, 32,418,179 parameters, bf16, batch 128, labelled Shapes):
   fit 10 steps (5 a call), a resume to 15 bitwise equal to an uninterrupted run,
   ``validate`` on the true labels, ``sample --trainer.sampler ddim``, the
   labelled train step timed and profiled;
26. CFG serve — ``LitDDIM(num_classes=2, guidance_scale=2)`` over HTTP:
   DDIM-50 at n = 1, 8, 16 (50 guided calls at N = 2n each), ``dpm`` and
   ``unipc`` at n = 8, the caching samplers answered 400, one request under
   the profiler;
27. guided IDDPM — ``LitIDDPM(num_classes=10, sample_steps=50)`` trains 3
   steps and answers one n = 8 request (ε guided, v conditional);
28. upsampler — the UNet of ``configs/ddpm/shapes_sr_demo.yaml`` in bf16
   with both switches: K1–K4 at its call sites (C = 32–128, C/G = 4, K3 at
   (T, D) = (64, 64)) against their plain versions; ``trainer.main fit``
   for 20 steps; ``generate(low_res=)`` at n = 8; ``serve`` refused;
29. f32 CFG — ``LitDDPM(num_classes=10)`` (f32) one step at batch 128; the
   loss and gradient with dropped labels and replayed dropout masks, and a
   guided DDIM step, within ``F32_REL_L2`` of the CPU, a bf16 control
   missing it;
30. ADM kernels — K3 at the 15 call sites of the ADM-32 generator of
   ``configs/adm/cifar10_guided.yaml`` (57,094,662 parameters, 4 heads of
   64 at T = 256, 64, 16; every weight random, the zero-initialised ones
   too) at serving forwards of n = 1, 8, 16 and one ``LitIDDPM`` training
   step at batch 128 (with the attention backward), at the 5 sites of the
   classifier-32 of ``configs/adm/cifar10_classifier.yaml`` (4,287,627) at
   one ``LitClassifier`` step at batch 256, and at both models' 20 inside
   one ``ClassifierGuidedDDIM`` step at n = 8; each held against its plain
   version (``TOL``) and timed beside SDPA; K1, K2 and K4 launch nothing;
31. ADM against the CPU — the bf16 forward (``UNET_REL_L2``) and hybrid-loss
   gradient (``GRAD_REL_L2``) at batch 8; the f32 ``LitIDDPM(model=ADM)``
   and ``LitClassifier()`` within ``F32_REL_L2``, each with a bf16 control
   that misses it; ``classifier_grad`` in bf16 and f32;
32. ADM fit — ``trainer.main fit`` of both ADM configs (synthetic CIFAR-10,
   the classifier's labelled) for 10 steps, the classifier resumed to 20
   bitwise against an uninterrupted run, then 5 timed steps of each
   (median, device busy, operations, idle share);
33. guidance — a ``ClassifierGuidedDDIM`` 25-step request at n = 8 on the
   trained cosine schedule (wall, launches, finite, identical bytes for a
   repeated seed, profiled), and 20 ``ClassifierGuidedDDPM`` steps timed
   and extrapolated to T = 1000;
34. ADM serve — ``LitIDDPM(ADM-32, sample_steps=25)`` over HTTP: ``default``
   at n = 1, 8, 16 and a repeat, ``ddim`` at n = 8, the caching samplers
   answered 400, one request profiled;
35. DiT kernels — K3 at the 12 call sites (6 heads of 64 at T = 64) of
   DiT-S/4 of ``configs/flow/cifar10_dit.yaml`` (32,499,120 parameters) and
   of the MoE-DiT of ``cifar10_dit_moe.yaml`` (82,143,456; 8 experts, top-2,
   in blocks 1, 3, …, 11), every weight random (adaLN-Zero kernels and
   expert biases too), at a serving forward of n = 8 and one ``LitFlow``
   training step at batch 128 of each (with the attention backward); each
   held against its plain version (``TOL``) and timed beside SDPA; K1, K2
   and K4 launch nothing;
36. DiT against the CPU — the bf16 forward at batch 8 (``UNET_REL_L2``, the
   dense DiT); the f32 DiT and MoE-DiT flow harnesses' loss (the routers'
   losses included) and gradient within ``F32_REL_L2``, each with a bf16
   control that misses it;
37. DiT fit — ``trainer.main fit`` of both DiT configs (synthetic CIFAR-10,
   batch 128) for 10 steps, the DiT resumed from step 5 bitwise against an
   uninterrupted run; the router losses that entered one MoE training loss
   and each MoE block's routed fractions f_e; 5 timed steps of each
   (median, device busy, operations, idle share, peak memory) and the MoE
   blocks' dense dispatch timed alone;
38. DiT serve — both DiT flow harnesses over HTTP: ``default`` (25 midpoint
   steps, 50 evaluations) and ``flow`` at 10 steps at n = 8, repeated for
   identical bytes, 12 K3 launches a forward, one request profiled;
39. distillation — every kernel call of one progressive-distillation step at
   batch 128 of the ε DDPM UNet (the teacher's two ``no_grad`` forwards: K4
   at N = 128, 22 sites each; the v student's K1/K2/K3), held against its
   plain version and timed, and the step timed; then
   ``python -m dmme_tpu_torch.distill`` on a temporary copy of
   ``configs/ddpm/cifar10.yaml`` whose teacher checkpoint a 2-step
   ``trainer fit`` wrote: 2 rounds (100, then 50 steps) of 3 steps, and
   the last student's DDIM-50 request at n = 8;
40. inpainting — ``inpaint`` with ``LitDDPM``'s UNet and DDPM (T = 100), the left
   half of n = 8 images known, ``resample_steps=2``: 200 forwards through
   K1, K3 and K4, the known pixels back bit for bit;
41. latent kernels — the default latent UNet (``LitLatentDDPM``'s: the DDPM
   UNet at in_channels 4, both switches) on 16x16x4 latents: every K1, K3
   and K4 call of forwards at n = 1, 8, 16 (1/6/22 a forward; ResBlocks
   down to 2x2, K3 at T = 4 and 64) and every K1, K2, K3 and attention
   backward call of one step at batch 128 (45/45/6/0; the bf16 codec
   encodes first, on library ops), the stage-2 config UNet's K3 and the
   latent DiT's (8 sites, 4 heads of 64 at T = 64) at a forward and a step,
   each held against its plain version, twice for identical bytes (every
   forward phase's K1, K3 and K4 calls and every training phase's K3 calls
   are repeated so since this phase), and timed;
42. latent against the CPU — the bf16 codec's encode and decode and the
   bf16 ``LitLatentDDPM`` loss and gradient (posterior noise, t, ε and
   dropout injected) within ``UNET_REL_L2``/``GRAD_REL_L2`` of f32 on the
   CPU; the f32 ``LitVAE()`` and ``LitLatentDDPM()`` within ``F32_REL_L2``,
   each with a bf16 control that misses it;
43. latent cli — ``trainer.main fit`` of configs/latent/shapes_vae_demo.yaml
   (10 steps, chunks of 5), then of shapes_latent_demo.yaml (a resume from
   5 to 10, bitwise the uninterrupted run) and
   shapes_latent_flow_dit_demo.yaml from its run directory; the written
   ``latent_scale.json`` equal to a recomputation; ``sample`` with and
   without ``--trainer.sampler ddim`` (32x32x3 grids); the stage-1 config's
   ``sample --trainer.sampler ddim`` refused; 5 timed steps at batch 128 of
   ``LitVAE``, the default ``LitLatentDDPM(dtype="bf16")`` over the trained
   codec and the latent DiT's ``LitLatentFlow``;
44. latent serve — ``LitLatentDDPM`` over HTTP at 32 px: ``ddim`` and ``dpm``
   at n = 8, one request profiled, the T = 1000 ancestral loop timed over
   20 steps and extrapolated with the decode; the latent DiT's ``default``
   flow request; a ``LitVAE``'s ``default`` (200) and ``ddim`` (400);
45. eval inception — the FID network (``InceptionV3``, the stand-in
   ``.pth`` of ``inception_standin`` loaded through ``load_torch_weights``)
   at batch 128, f32 with TF32 off, against the unfolded twin on the card
   and the CPU (``INCEPTION_REL_L2``), a TF32-on control that must miss it;
   ``preprocess`` at 32 and 320 px against the CPU; the card's f32
   ``FeatureStats`` of 256 + 256 samples against float64 (sums within
   ``STATS_REL_L2``, moments beside the CPU's f32 ones, the FID within
   ``FID_REL`` or what the CPU's f32 sums leave) and ``python -m
   dmme_tpu_torch.fid`` on the same images; the feature function's ms with
   TF32 off and on, the statistics update's, the forward's peak memory;
46. eval test — ``trainer.main test`` (deterministic cuDNN, 2 batches of
   128): ``configs/ddim/cifar10.yaml`` from a 20-step ``fit`` with
   ``save_fid_stats``, with ``fid_stats`` (the same FID within 1e-6) and
   repeated (bitwise the same results), with ``--trainer.sampler dpm``;
   ``configs/ddpm/shapes_cfg_demo.yaml`` (guided calls at N = 256) and
   ``configs/latent/shapes_latent_demo.yaml`` from phase 43's runs with
   ``--trainer.sampler ddim``; the ``LitVAE`` config and ``cached``
   refused with JAX's messages; launches per batch = steps × the call
   sites of a meta-device forward, no f32, fp16 or ``simt.cu`` launch;
   every K1/K3/K4 call of the first run held against its plain version
   (``TOL``), twice for identical bytes, and timed; one test batch split
   (generation s, Inception ms, statistics ms, idle share from a profile);
47. LSUN fit — ``trainer.main fit`` of configs/ddpm/lsun_church.yaml
   (batch 2, 256 px, remat, bf16, the LSUN widths; ``fused_norm`` and
   ``fused_block`` on and a log line a step; cut in depth by
   ``LSUN_DEPTH``: 4 accumulated microbatches a step, not 32, and a DDPM of
   T = 100, not 1000) for 2 steps on a
   synthetic LMDB of 96 JPEGs (256×341 and 300×256) read by the native
   scanner into the memmap decode cache, with the config's GenerateImage
   and ``ProfileTrace`` over step 2: the steps' launches = 2 × 4 × a
   microbatch's call sites and the grid's = 100 × a sampling forward's,
   each counted apart, no f32, fp16 or ``simt.cu`` launch; the trace names
   K1, K2 and K3 (the step's idle share); the losses finite; one more step
   of 2 microbatches resumed in streaming mode; the decode's host time,
   each step's and the
   grid's host time, the peak memory; every K1/K3/K4 call of a
   sampling forward at n = 4 and K1/K2/K3 call of one microbatch held
   against its plain version (``TOL``), twice for identical bytes, and
   timed; whether remat lowers a microbatch's peak memory
   (``remat_peaks``); the bf16 loss, gradient and forward of one 128-px
   image against
   f32 on the CPU;
48. ImageNet-64 — ``trainer.main fit`` of configs/iddpm/imagenet64.yaml
   as written (batch 128, 64 px, 4 heads of 96 and 128, hybrid loss,
   cosine T = 4000, remat, ``fused_norm``; its mesh ``{data: -1, fsdp: 1}``
   a world of 1 over NCCL) for 3 steps on a synthetic
   ``train_data_batch_1.npz`` of 512 rows, and again with ``--trainer.mesh
   null``: the two saved states bitwise equal (deterministic cuDNN); then
   ``sample --trainer.sampler ddim --trainer.sample_batch 8`` with
   ``fused_block`` (K4 at the 30 ResBlocks, C 384 and 768); launches as the
   call sites say; the step (median of 5) with and without the mesh (NCCL's
   all-reduce in a profiled mesh step) and the request timed with their idle
   shares; every K1/K2/K3 call of a step at batch 128 and K1/K3/K4 call of a
   forward at n = 8 held against its plain version, twice, and timed; the
   bf16 loss, gradient (batch 2) and forward against f32 on the CPU;
   whether remat lowers a training step's peak memory (``remat_peaks``);
49. two ranks on one card — ``python -m torch.distributed.run --standalone
   --nproc_per_node 2 chip_smoke.py --rank-worker DIR`` (gloo on CUDA
   tensors; NCCL refuses two ranks on one device): ``trainer.main fit`` of
   configs/ddpm/cifar10.yaml (global batch 128, synthetic data, 3 steps)
   with ``--trainer.mesh.data 2`` and with ``--trainer.mesh.fsdp 2``; the
   data run's saved state bitwise that of one process here at batch 64
   with ``accumulate_grad_batches 2``, the fsdp run's parameters within 1e-6
   (relative L2) of it, each fsdp rank holding about half a data rank's
   bytes of parameters, EMA and moments; each rank's launches a batch-64
   step's (no f32, fp16 or ``simt.cu``); each rank's step and the gradient
   all-reduce timed; K1/K2/K3 at every call site of a batch-64 step held
   against their plain versions. In the same launch, the ``expert`` axis:
   ``trainer.main fit`` of configs/flow/cifar10_dit_moe.yaml at full width
   (the MoE-DiT, bf16, global batch 128, 3 steps, every zero-initialised
   weight drawn) with ``--trainer.mesh "{data: -1, expert: 2}"``: each
   step's loss and grad norm within 1e-2 of one process here at batch 64
   accumulating 2, the first step's reduced gradient gathered whole within
   ``GRAD_REL_L2`` of that process's, the run's checkpoint restored here
   without a mesh bit for bit its ranks' gathered state, each rank holding
   861,310,464 B of parameters, EMA and moments (the whole less half the
   expert stacks), 12 K3 launches a step and nothing else; the transport of
   the all-to-alls printed; a rank's step and one block's all-to-all
   timed; K3 at every call site of a rank's batch-64 step held against its
   plain version. In the same launch, the ``tensor`` axis:
   ``trainer.main fit`` of configs/ddpm/lsun_church.yaml at full width
   (``fused_norm`` on, every bias and GroupNorm affine drawn; 1 step of 2
   microbatches, not 32) with ``--trainer.mesh "{data: -1, tensor: 2}"``:
   each rank holding 782,362,672 B in 140 split kernels, each step's loss
   and grad norm within 1e-2 of one process here on the same batches
   without a mesh, the first reduced gradient gathered whole within
   ``GRAD_REL_L2`` of that process's, the checkpoint restored here without
   a mesh bit for bit the gathered state, each rank's launches the one
   process's and its K1/K2 call sites at the shard shapes (C/2 channels,
   G/2 groups) those of the half-width UNet, its K3 sites phase 47's; no
   f32, fp16 or ``simt.cu`` launch; a rank's step and its largest
   activation all-gather timed; K1/K2 at every call site of the half-width
   UNet's microbatch held against their plain versions. In the same
   launch, the ``tensor`` axis for the DiTs: ``trainer.main fit`` of
   configs/flow/cifar10_dit.yaml and configs/flow/cifar10_dit_moe.yaml at
   full width (bf16, global batch 128 on both ranks, 2 steps, every
   zero-initialised weight drawn) with ``--trainer.mesh "{data: -1,
   tensor: 2}"``: each rank holding 260,561,664 B and 658,509,312 B in 65
   split kernels, each step's loss and grad norm within 1e-2 of one process
   here on the same batches without a mesh, the first reduced gradient
   (the routers' too) gathered whole within ``GRAD_REL_L2`` of that
   process's, the checkpoint restored here without a mesh bit for bit the
   gathered state; each rank's launches the one process's (12 K3 a step:
   the attention runs whole) at phase 35's K3 call sites, K3 held against
   its plain version on the rank's own inputs; no f32, fp16 or ``simt.cu``
   launch; a rank's step and its largest activation all-gather timed. In
   the same launch, the ``spatial`` axis: ``trainer.main fit`` of
   configs/ddpm/lsun_church.yaml as the tensor fit runs it, with
   ``--trainer.mesh "{data: -1, spatial: 2}"`` (each rank H/2 rows of every
   activation): the losses, grad norms and first gradient held against the
   tensor fit's one process (the same batches and draws) as the tensor
   fit's are, both ranks' states bitwise equal and the checkpoint restored
   without a mesh bitwise theirs; each rank's launches the split K1/K2
   entries (``group_norm.cu``) at the one process's K1/K2 counts, K3 at its
   count, nothing of the one-call K1/K2, f32, fp16 or ``simt.cu``; the
   split entries and K3 held against their plain versions on each rank's
   own inputs; each rank's peak memory below the one process's; its halo
   exchanges and statistics all-reduces a microbatch counted and its
   largest halo exchange timed (the tensor rank's peak is read too);
50. two-rank test — in the same launch, ``trainer.main test`` of
   configs/ddim/cifar10.yaml from phase 46's run with
   ``--trainer.mesh.data 2``, one test batch a rank: phase 46's FID and IS
   (the relative differences printed), each rank one batch's launches;
51. four ranks on one card — ``python -m torch.distributed.run
   --standalone --nproc_per_node 4 chip_smoke.py --quad-worker DIR`` (gloo
   on CUDA tensors), on phase 49's files: ``trainer.main fit`` of
   configs/ddpm/lsun_church.yaml as the tensor fit runs it, with
   ``--trainer.mesh "{data: -1, tensor: 2, spatial: 2}"`` (each rank H/2
   rows of C/2 channels of every activation): the losses, grad norms and
   first gradient held against the tensor fit's one process, the two ranks
   of each spatial group bitwise equal, the checkpoint restored without a
   mesh bitwise the gathered state, each rank holding 782,362,672 B in 140
   split kernels; each rank's launches the split K1/K2 entries at the
   spatial rank's call sites with C halved and the one process's counts, K3
   at its sites, nothing else; the split entries and K3 held against their
   plain versions on each rank's inputs; the group collectives a
   microbatch, a rank's step, the largest halo and channel all-gather
   timed, the peak beside the spatial and tensor ranks'. Then
   ``trainer.main fit`` of configs/ddpm/cifar10.yaml (global batch 128,
   synthetic data, 3 steps) with ``--trainer.mesh "{data: -1, expert: 2,
   spatial: 2}"``: its parameters and EMA within 1e-5 (relative L2) of
   phase 49's one process at batch 64 accumulating 2, every rank bitwise
   equal and the checkpoint theirs, each rank a batch-64 step's launches on
   the split entries;
52. the kernel table as one JSON line, the card's name and power limit, then
   ``{"ok": true, "device": ...}``.

``--out`` also writes every measurement to a JSON file. ``--kernels-only``
runs phases 1–3, 6, 6b, 6c, the LSUN forward of phase 4 and phase 10's
f32 and fp16 training steps with their K1 and K2 rows, then stops and
prints no result line: a short first check of new kernels.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): memory, bf16 (and
# fp16) tensor cores, TF32 tensor cores, and f32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
# K3 and K4 in f32 run as 3xTF32: three tf32 products for each f32 product,
# the least time of f32-accurate products on the card
F32_TC_FLOPS = TF32_FLOPS / 3

BATCH = 8
SERVE_BATCHES = (1, 8, 16)  # the request sizes of the serve phase
SEED = 0  # random weights (biases and GroupNorm affines included) and inputs
# bf16 outputs compared in f32 against the plain version of the same math
# (tests/test_ops.py::test_bf16_path's bound). The fused ResBlock rounds its
# normalised activations to bf16 before each conv; where the kernel's f32
# statistics differ from the plain version's in the last bits, single
# elements round the other way, and 9·C_in such products add into each
# output: a looser atol covers that.
TOL = {"group_norm_silu": (2e-2, 1e-2), "attention": (2e-2, 1e-2),
       "resblock": (2e-2, 5e-2)}
# full UNet, bf16 on the card against f32 on the CPU: relative L2 error
UNET_REL_L2 = 5e-2
# the f32 harness on the card against f32 on the CPU, relative L2: the same
# math summed in another order reads ~1e-6; the bf16 harness reads ~5e-3,
# and fails this limit (the phase checks that it does)
F32_REL_L2 = 1e-4
# the f32/fp16 kernels (K1 and K2 of group_norm.cu, K3 and K4 on the tensor cores)
# against their plain versions on the same inputs: (rtol, atol as a share of
# the largest reference value, least atol). f32: the same arithmetic in
# another order (K3 and K4 as 3xTF32, ~2^-21 a product), f32 rounding grown
# by sums of up to ~1e5 terms. fp16: outputs rounded to fp16 (2^-11
# relative, and 2^-24 apart in its subnormal range, where a training step's
# small gradients fall) from f32 values that differ in their last bits
TOL_SIMT = {"torch.float32": (1e-4, 1e-5, 0.0), "torch.float16": (4e-3, 2e-3, 2.0 ** -24)}
# the LSUN widths of configs/ddpm/lsun_*.yaml, run at batch 1 and 256x256
LSUN_WIDTHS = dict(channels_per_depth=(128, 128, 256, 256, 512, 512), attention_depths=(5,))
LSUN_IMG = 256
# K2 on the training path: gradients have no fixed scale, so atol is a share
# of the largest reference value. dx is bf16, one rounding of an f32 value
# (a bf16 ulp is 2^-8 of it), from group means summed in another order than
# the plain version's; dγ, dβ and dbias are f32 sums over H·W in another order.
TOL_BWD = {"dx": (2e-2, 1e-2), "vec": (1e-3, 1e-3)}
# attention backward against autograd of the plain forward, relative L2: the
# port rounds the scores to bf16 before the softmax, as the JAX backward does
# (``_fused_bwd``), where the plain forward keeps them in f32
ATTN_BWD_REL_L2 = 2e-2
# one training step at batch 8, bf16 on the card against f32 on the CPU:
# relative L2 of the flattened gradient
GRAD_REL_L2 = 5e-2
TRAIN_BATCH = 128
FIT_WARM, FIT_STEPS, TIMED_STEPS = 3, 20, 5
# timed steps of the default harness in f32 and fp16 (the script's 25)
HARNESS_TIMED_STEPS = 10
#: the batch of the f32 phases' loss and gradient against the CPU: the card's
#: kernels are held at batch 128 against their plain versions there, and the
#: CPU's f32 reference cost most of those phases' time (8 until the spatial
#: fit needed the seconds)
CPU_REF_BATCH = 4
# launches of one training step of the full-width UNet
PER_TRAIN_STEP = {"group_norm_silu": 45, "group_norm_silu_bwd": 45, "attention": 6,
                  "resblock": 0}
# launches of one eval forward of the DDPM UNet (both switches on): full, and
# the partial forwards of the caching samplers' non-key steps: ``cached``
# skips the down path (8 ResBlocks, 2 with attention), ``deep`` at
# cache_depth 1 runs the 2 shallow down and 3 shallow up ResBlocks only
PER_FORWARD = {"group_norm_silu": 1, "group_norm_silu_bwd": 0, "attention": 6, "resblock": 22}
PER_FORWARD_CACHED = {"group_norm_silu": 1, "group_norm_silu_bwd": 0, "attention": 4,
                      "resblock": 14}
PER_FORWARD_DEEP = {"group_norm_silu": 1, "group_norm_silu_bwd": 0, "attention": 0,
                    "resblock": 5}
# the discrete-schedule solvers and their default steps; the caching samplers
# (refresh interval 2, cache depth 1) and theirs
SOLVERS = (("ddim", 50), ("dpm", 20), ("unipc", 10))
CACHING = (("cached", 50, PER_FORWARD_CACHED), ("deep", 50, PER_FORWARD_DEEP),
           ("deep_dpm", 20, PER_FORWARD_DEEP))
# bench.py:60-63: 3.53 TFLOP per batch-128 train step (forward, backward and
# optimizer), a work count traced from the JAX package's XLA program, not a
# time; over the card's bf16 peak it bounds a step from below
TRAIN_STEP_TFLOP = 3.53


# runs of each plain version timed (``device_ms``): they are yardsticks tens
# to hundreds of times slower than the kernels, and more runs of them cost
# more of the run's time budget than they add to the ratio's precision
PLAIN_REPS = 2
# warm calls before a plain version's timed runs: the error check has just
# run it once on the same inputs
PLAIN_WARM = 1
# timed runs of a kernel or library yardstick (``device_ms``) after its two
# warm calls: timing a call site cost most of the whole run's time
KERNEL_REPS = 5


def fail(msg: str) -> None:
    raise RuntimeError(msg)


_T0 = time.time()
#: [(name, start)] of the run's phases
_PHASES = []


def phase(name: str) -> None:
    now = time.time()
    if _PHASES:
        print(f"(phase {len(_PHASES)} took {now - _PHASES[-1][1]:.1f} s)", flush=True)
    _PHASES.append((name, now))
    print(f"\n== {name} == ({now - _T0:.1f} s into the run)", flush=True)


def phase_seconds() -> list:
    """[(phase, seconds)] of the run's phases so far, the last one up to now."""
    ends = [t for _, t in _PHASES[1:]] + [time.time()]
    return [(name, end - t) for (name, t), end in zip(_PHASES, ends)]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


#: SM clock cycles in a millisecond of ``torch.cuda._sleep``, measured once
_SLEEP_CYCLES_PER_MS = []


def sleep_cycles(torch, host_s: float) -> int:
    """Cycles of a sleep kernel that lasts four times ``host_s`` (a call's
    host enqueue time), at least 0.1 ms and at most 2·10⁶ cycles (≈ 1 ms)."""
    if not _SLEEP_CYCLES_PER_MS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000)
        start.record()
        torch.cuda._sleep(2_000_000)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(2_000_000 / start.elapsed_time(end))
    return int(min(2_000_000, max(0.1, 4e3 * host_s) * _SLEEP_CYCLES_PER_MS[0]))


def device_ms(torch, fn, reps: int = KERNEL_REPS, warm: int = 2) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` runs after ``warm``
    (at least 1). A sleep kernel queued before each run, four times as long
    as the last warm call took the host to enqueue, lets the host enqueue
    the whole call before the start event fires, so the interval holds
    device time, not launch overhead."""
    for _ in range(warm):
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = sleep_cycles(torch, host_s)
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def errors(got, want, rtol: float, atol: float):
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / w.abs().clamp_min(1e-6)).max())
    ok = bool((diff <= atol + rtol * w.abs()).all()) and bool(g.isfinite().all())
    return max_abs, max_rel, ok


def randomize_affines(torch, blocks, module, generator) -> None:
    """Every Conv and Dense bias 0.1·N(0, 1), every GroupNorm weight
    1 + 0.1·N(0, 1) and bias 0.1·N(0, 1), every zero-initialised kernel
    (ADM's ``ZeroConv``s, DiT's adaLN-Zero ``ZeroDense``s) N(0, 1/fan_in)
    and every MoE expert bias 0.1·N(0, 1), drawn from ``generator``. The
    flax init leaves them 0 and 1, where a kernel that dropped or misplaced
    one would still agree with its plain version (and a zero attention
    projection or adaLN gate would hide K3 altogether)."""
    def draw(p, mean, std=0.1):
        p.copy_(mean + std * torch.randn(p.shape, generator=generator))

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (blocks.Dense, blocks.Conv)):
                draw(m.bias, 0.0)
                if isinstance(m, (blocks.ZeroConv, blocks.ZeroDense)):
                    draw(m.weight, 0.0, m.weight[0].numel() ** -0.5)
            elif isinstance(m, blocks.GroupNorm):
                draw(m.weight, 1.0)
                draw(m.bias, 0.0)
            elif hasattr(m, "init_parameters"):  # an MoE layer's expert biases
                draw(m.b_in, 0.0)
                draw(m.b_out, 0.0)


#: the launch counters of the kernels that take f32 and fp16 activations,
#: {route: {kernel: (module, attribute)}}: K1's to K4's instances in fp16
#: and in f32, and K1's and K2's in ``csrc/simt.cu`` ("simt", any dtype, at
#: widths outside group_norm.cu's domain: none on a main path); set by main()
WIDE = {}


def reset_counts(ops) -> None:
    """``ops``: {kernel: (module, counter attribute)}; the f32/fp16 counters too."""
    for m, attr in list(ops.values()) + [v for d in WIDE.values() for v in d.values()]:
        setattr(m, attr, 0)


def wide_counts() -> dict:
    """{route: {kernel: launches}} of the f32/fp16 counters."""
    return {r: {k: getattr(m, attr) for k, (m, attr) in d.items()} for r, d in WIDE.items()}


def wide_expected(dtype_name: str, per_kernel: dict) -> dict:
    """What :func:`wide_counts` reads after ``per_kernel`` launches of K1–K4
    in ``dtype_name`` ("f32" or "fp16"): each on that dtype's instance,
    nothing on the other's and nothing on ``simt.cu``."""
    return {r: {k: per_kernel[k] if r == dtype_name else 0 for k in d}
            for r, d in WIDE.items()}


def expect_bf16_only(where: str) -> dict:
    """Fail if a bf16 path launched an f32 or fp16 kernel or ``simt.cu``."""
    got = wide_counts()
    print(f"{where}: f32/fp16 launches {got}", flush=True)
    if any(v for d in got.values() for v in d.values()):
        fail(f"{where}: a bf16 path launched the f32/fp16 kernels: {got}")
    return got


def counts(ops) -> dict:
    return {k: getattr(m, attr) for k, (m, attr) in ops.items()}


def _sig_gn(x, gamma, beta, groups, eps=None, pre_bias=None):
    return (tuple(x.shape), gamma.dim() == 2, pre_bias is not None)


def _sig_gn_bwd(x, dz, gamma, beta, pre_bias, mean, inv, groups):
    return (tuple(x.shape), gamma.dim() == 2, pre_bias is not None)


def _sig_attn(q, k, v, scale, *rest):
    return (tuple(q.shape), tuple(q.stride()))


def _sig_res(x, *a, wr=None, **k):
    return (tuple(x.shape), int(a[5].shape[0]), wr is not None)


def serve_targets(blocks):
    """The three kernel entry points of the UNet blocks' forward."""
    return [(blocks, "group_norm_silu", "group_norm_silu", _sig_gn),
            (blocks, "attention_heads", "attention", _sig_attn),
            (blocks, "resblock_forward", "resblock", _sig_res)]


def train_targets(blocks, k_gn, k_attn):
    """The forward entry points and the two backward ones of a training step."""
    return [(blocks, "group_norm_silu", "group_norm_silu", _sig_gn),
            (k_gn, "group_norm_silu_bwd", "group_norm_silu_bwd", _sig_gn_bwd),
            (blocks, "attention_heads", "attention", _sig_attn),
            (k_attn, "attention_bwd", "attention_bwd", _sig_attn)]


def record_calls(targets, fn, inputs: bool = True):
    """Run ``fn()`` with each ``(module, attribute, kind, signature)`` entry
    point wrapped so that the first call of each distinct signature keeps
    its inputs (with ``inputs`` false, only the counts: a run whose peak
    memory is read holds nothing more). Returns {kind: [(signature, count,
    args, kwargs)]}."""
    seen = {kind: {} for _, _, kind, _ in targets}
    originals = []

    for module, attr, kind, sig in targets:
        orig = getattr(module, attr)
        originals.append((module, attr, orig))

        def wrapped(*a, _orig=orig, _kind=kind, _sig=sig, **k):
            entry = seen[_kind].setdefault(_sig(*a, **k), [0, a, k] if inputs else [0, (), {}])
            entry[0] += 1
            return _orig(*a, **k)

        setattr(module, attr, wrapped)
    try:
        fn()
    finally:
        for module, attr, orig in originals:
            setattr(module, attr, orig)
    return {kind: [(key, e[0], e[1], e[2]) for key, e in d.items()]
            for kind, d in seen.items()}


def _kernel_group(name: str) -> str:
    for needle, label in (("conv_wgmma_kernel", "K4 conv (resblock.cu)"),
                          ("gn_silu_kernel", "K4 gn_silu (resblock.cu)"),
                          ("splitk_reduce_kernel", "K4 split-K sum (resblock.cu)"),
                          ("attn_fwd_kernel", "K3 attention (attention.cu)"),
                          ("attn_combine_kernel", "K3 split merge (attention.cu)"),
                          ("gn_fwd_cluster_kernel", "K1 group_norm_silu (group_norm.cu)"),
                          ("gn_apply_kernel", "K1 two-pass apply (group_norm.cu)"),
                          ("gn_bwd_cluster_kernel", "K2 group_norm_silu backward (group_norm.cu)"),
                          ("gn_dx_kernel", "K2 two-pass dx (group_norm.cu)"),
                          ("gn_partial_kernel", "K1/K2 two-pass partials (group_norm.cu)"),
                          ("gn_finalize_kernel", "K1/K2 two-pass sums (group_norm.cu)")):
        if needle in name:
            return label
    return name[:90]


def ptxas_report(build) -> dict:
    """{source: {kernel: registers and spill bytes}} of every CUDA source built
    in this run, read from its ``-Xptxas -v`` log; names demangled where
    ``c++filt`` is found, without the parameter list."""
    out = {}
    for src, log in build.LOGS.items():
        usage = build.ptxas_usage(log)
        names = list(usage)
        try:
            r = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, timeout=60, check=True)
            plain = r.stdout.splitlines()
        except (OSError, subprocess.SubprocessError):
            plain = names
        for mangled, name in zip(names, plain):
            name = name.replace("(anonymous namespace)::", "").split("(")[0]
            out.setdefault(src, {})[name.removeprefix("void ")] = usage[mangled]
    return out


def gn_sequence(torch, a, k, dz=None):
    """One K1 call's function as a library sequence on the same bf16 NHWC
    tensor: the pre-bias add, ``F.group_norm`` and ``F.silu``; with ``dz``,
    K2's: autograd through that sequence to x, γ, β and the pre-bias. A
    yardstick the port never calls; the affine is the batch's (C,) row."""
    F = torch.nn.functional
    x, gamma, beta, groups = a[:4]
    eps, bias = k.get("eps", 1e-5), k.get("pre_bias")
    g, b = (v if v.dim() == 1 else v[0] for v in (gamma, beta))

    def fwd(xx, gg, bb, pp):
        u = xx if pp is None else xx + pp.to(xx.dtype)[:, None, None, :]
        return F.silu(F.group_norm(u.permute(0, 3, 1, 2), groups, gg, bb, eps))

    g, b = g.to(x.dtype), b.to(x.dtype)
    if dz is None:
        return lambda: fwd(x, g, b, bias)
    leaves = [t.detach().requires_grad_(True) for t in (x, g, b)]
    if bias is not None:
        leaves.append(bias.detach().requires_grad_(True))
    with torch.enable_grad():
        out = fwd(*leaves[:3], leaves[3] if bias is not None else None)
    dz = dz.permute(0, 3, 1, 2)
    return lambda: torch.autograd.grad(out, leaves, dz, retain_graph=True)


def attention_plan(k_attn, q, k, v) -> dict:
    """K3's plan for the recorded q, k, v (in f32, with the layout the
    kernel reads them in), as a dict."""
    n, t, h, d = q.shape
    size = q.element_size()
    trans = size == 4 and k_attn.f32_layout(q, k, v, -(-d // 64) * 64)
    plan = k_attn.attention_plan(n, h, t, d, k_attn.build.sm_count(q.device), size, trans)
    return dict(plan._asdict(), trans=trans)


def cudnn_sequence(torch, pa):
    """The ResBlock of one K4 call (``resblock_plain``'s arguments) as a
    library sequence on channels-last tensors in x's dtype: F.group_norm,
    F.silu and two F.conv2d (cuDNN; f32 without TF32, as main() sets it),
    plus the skip. A yardstick the port never calls; the weights are cast
    once, outside the returned function."""
    F = torch.nn.functional
    x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br, groups, eps = pa
    dt = x.dtype
    w1c, w2c = (w.to(dtype=dt, memory_format=torch.channels_last) for w in (w1, w2))
    wrc = None if wr is None else wr.to(dtype=dt, memory_format=torch.channels_last)
    b1c, b2c = b1.to(dt), b2.to(dt)
    brc = None if br is None else br.to(dt)
    ga1, be1, ga2, be2 = (v[0].to(dt) for v in (g1, b1v, g2, b2v))
    pre = pre2.to(dt)[:, :, None, None]
    xc = x.permute(0, 3, 1, 2)  # NHWC storage: a channels-last NCHW view

    def run():
        h = F.silu(F.group_norm(xc, groups, ga1, be1, eps))
        h = F.conv2d(h, w1c, b1c, padding=1) + pre
        h = F.silu(F.group_norm(h, groups, ga2, be2, eps))
        h = F.conv2d(h, w2c, b2c, padding=1)
        return h + (xc if wrc is None else F.conv2d(xc, wrc, brc))

    return run


def profile_request(torch, sampler, n: int, name: str = "default") -> dict:
    """Device time by kernel over one ``/sample``-sized request."""
    return profile_fn(torch, lambda: sampler.sample(n, sampler=name, seed=5))


#: a device event of a ``torch.profiler`` Chrome trace, as ``export_chrome_trace``
#: writes it (category, name, then pid, tid, ts and dur)
_DEVICE_EVENT = re.compile(r'"cat": "(kernel|gpu_memcpy|gpu_memset)",'
                           r'\s*"name": "((?:[^"\\]|\\.)*)",'
                           r'\s*"pid": [^,]*,\s*"tid": [^,]*,\s*"ts": ([0-9.e+-]+),'
                           r'\s*"dur": ([0-9.e+-]+)')


def device_events(path: str) -> list:
    """(category, name, start µs, duration µs) of every kernel, copy and
    memset in a Chrome trace that ``torch.profiler`` exported, read by
    scanning the file: a JSON parse of a trace of 10^6 events takes tens of
    seconds and gigabytes."""
    with open(path) as f:
        text = f.read()
    events = [(cat, name, float(ts), float(dur))
              for cat, name, ts, dur in _DEVICE_EVENT.findall(text)]
    listed = sum(text.count(f'"cat": "{cat}"') for cat in ("kernel", "gpu_memcpy", "gpu_memset"))
    if len(events) != listed:
        fail(f"{path}: {len(events)} device events read of the {listed} the file lists")
    return events


def profile_fn(torch, fn, top_n: int = 12) -> dict:
    """Device time by kernel over ``fn()``, read from a torch.profiler trace
    of the device's activity alone (the host's operations are not recorded:
    nothing here reads them, and recording them cost seconds a trace):
    busy time is the sum of kernel, copy and memset durations on the device;
    idle share is 1 − busy / wall."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        events = device_events(path)
    groups = {}
    for _, name, _, dur in events:
        g = groups.setdefault(_kernel_group(name), [0.0, 0])
        g[0] += dur / 1e3
        g[1] += 1
    busy = sum(v[0] for v in groups.values())
    if busy <= 0:
        fail("the profiler trace holds no device time")
    ops = sum(v[1] for v in groups.values())
    top = sorted(((k, v[0], v[1]) for k, v in groups.items()), key=lambda r: -r[1])[:top_n]
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "device_ops": ops, "top": top}


def host_ops(torch, fn) -> dict:
    """{name: host ms} of the operations a torch.profiler trace of ``fn()`` records."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()}


def _vector_bytes(v) -> int:
    """f32 bytes of an (N, C) or (C,) vector, one row when the batch shares it."""
    if v is None:
        return 0
    return 4 * (v.shape[-1] if v.dim() == 1 or v.stride(0) == 0 else v.numel())


def bound_ms(kind: str, args, kwargs, f32_rate: float = F32_TC_FLOPS) -> tuple:
    """(least ms, what bounds it) for the work of one call: each input read
    once, each output written once, and the operations at the card's peak
    for the activations' type (bf16 and fp16 on the tensor cores; K3's and
    K4's f32 products as 3xTF32 on them, ``f32_rate``; GroupNorm's
    arithmetic and the attention backward's f32 off them)."""
    if kind == "group_norm_silu":
        x, gamma, beta, groups = args[:4]
        n, h, w, c = x.shape
        nbytes = (2 * x.numel() * x.element_size() + _vector_bytes(gamma)
                  + _vector_bytes(beta) + _vector_bytes(kwargs.get("pre_bias"))
                  + 2 * n * groups * 4)
        ops = 10 * x.numel()  # sums, affine, sigmoid: ~10 f32 operations per element
        rate = F32_FLOPS
    elif kind == "group_norm_silu_bwd":
        x, dz, gamma, beta, pre_bias, mean, inv, groups = args
        n, h, w, c = x.shape
        # x, dz read and dx written once; the affines and pre-bias read, the
        # (N, G) statistics read, the three (N, C) f32 sums written
        nbytes = (3 * x.numel() * x.element_size() + _vector_bytes(gamma)
                  + _vector_bytes(beta) + _vector_bytes(pre_bias) + 2 * n * groups * 4
                  + 3 * n * c * 4)
        ops = 25 * x.numel()  # x̂, y, σ, dy, four sums, dx: ~25 f32 operations per element
        rate = F32_FLOPS
    elif kind == "attention":
        q = args[0]
        n, t, h, d = q.shape
        nbytes = 4 * q.numel() * q.element_size()
        ops = 4 * n * h * t * t * d
        rate = f32_rate if q.element_size() == 4 else BF16_FLOPS
    elif kind == "attention_bwd":
        q = args[0]
        n, t, h, d = q.shape
        nbytes = 7 * q.numel() * q.element_size()  # q, k, v, g in; dq, dk, dv out
        ops = 10 * n * h * t * t * d  # QKᵀ again, then dV, dP, dQ, dK
        rate = F32_FLOPS if q.element_size() == 4 else BF16_FLOPS
    else:
        x, w1, w2 = args[0], args[6], args[8]
        wr = kwargs.get("wr")
        n, h, w, cin = x.shape
        cout = w1.shape[0]
        m = n * h * w
        # x, out and the conv weights (as the kernel reads them) in x's
        # dtype; b1 and b2 (+ br) f32; the five affine vectors f32
        size = x.element_size()
        weights = w1.numel() + w2.numel() + (wr.numel() if wr is not None else 0)
        nbytes = (size * (x.numel() + m * cout + weights) + 2 * 4 * cout
                  + sum(_vector_bytes(v) for v in args[1:6]))
        k = 9 * cin + 9 * cout + (cin if wr is not None else 0)
        ops = 2 * m * cout * k
        rate = f32_rate if size == 4 else BF16_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rel_l2(got, want) -> float:
    g, w = got.float().flatten(), want.float().flatten()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def scaled_errors(got, want, rtol: float, atol_share: float):
    """:func:`errors` with atol a share of the largest reference value."""
    return errors(got, want, rtol, atol_share * float(want.float().abs().max()))


def train_kernels(torch, blocks, k_gn, k_attn, ddpm_models, init_weights, lit_cls, dev,
                  card: str, ops=None, lit=None, batch_size: int = TRAIN_BATCH,
                  labels: int = None, targets=None, sites: dict = None, img_size: int = 32,
                  dm=None) -> dict:
    """Phase 6: K1, K2, K3 and the attention backward at every call site of one
    full-width bf16 training step at batch 128 of ``lit_cls(dtype="bf16")``
    (or of the harness ``lit`` at ``batch_size`` and ``img_size`` through
    the data module ``dm``, by default CIFAR-10's flip; with ``labels``, on
    a labelled batch of that many classes), each held against its plain
    version on the recorded inputs, with times and bounds. With ``ops``, the
    step's launches are held too: 2r + 1/2r + 1/n/0 (K1/K2/K3/K4, r the
    model's ResBlocks, n its attention sites: 45/45/6/0 for the DDPM UNet).
    ``targets`` and ``sites`` replace the UNet's entry points
    (:func:`train_targets`) and call sites, for a model that reaches the
    kernels elsewhere (ADM: K3 and its backward only) or more than once
    (under remat, :func:`config_sites`)."""
    from dmme_tpu_torch.data import CIFAR10

    lit = lit_cls(dtype="bf16") if lit is None else lit
    init_weights(lit.model, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, lit.model, torch.Generator().manual_seed(SEED + 1))
    params = {k: v.detach().to(dev).requires_grad_(True)
              for k, v in lit.model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = torch.randint(0, 256, (batch_size, img_size, img_size, 3), generator=gen, device=dev,
                          dtype=torch.uint8)
    if labels is not None:
        batch = (batch, torch.randint(0, labels, (batch_size,), generator=gen, device=dev))
    # flip, process, loss
    loss_fn = lit.make_loss_fn(CIFAR10(batch_size=batch_size) if dm is None else dm)
    if sites is None:
        n_gn = 2 * sum(isinstance(m, blocks.ResBlock) for m in lit.model.modules()) + 1
        n_attn = sum(isinstance(m, blocks.SelfAttention2d) for m in lit.model.modules())
        sites = {"group_norm_silu": n_gn, "group_norm_silu_bwd": n_gn, "attention": n_attn,
                 "attention_bwd": n_attn}

    def step():
        loss = loss_fn(params, gen, batch)
        torch.autograd.grad(loss, list(params.values()))

    if ops is not None:
        reset_counts(ops)
    calls = record_calls(train_targets(blocks, k_gn, k_attn) if targets is None else targets,
                         step)
    torch.cuda.synchronize()
    launches = counts(ops) if ops is not None else None
    got_sites = {k: sum(c for _, c, _, _ in v) for k, v in calls.items()}
    print(f"call sites per training step: {json.dumps(got_sites)}; launches {launches}",
          flush=True)
    if got_sites != sites:
        fail(f"training step call sites {got_sites}, expected {sites}")
    if launches is not None:
        expect_bf16_only("training step")
        want = {"group_norm_silu": sites.get("group_norm_silu", 0),
                "group_norm_silu_bwd": sites.get("group_norm_silu_bwd", 0),
                "attention": sites["attention"], "resblock": 0}
        if launches != want:
            fail(f"a training step launched {launches}, expected {want}")

    rows, per_step = step_rows(torch, k_gn, k_attn, calls, card,
                               f"per training step (batch {batch_size})")
    return {"shapes": rows, "per_step": per_step, "launches": launches}


def step_rows(torch, k_gn, k_attn, calls, card: str, label: str) -> tuple:
    """Hold each recorded call of K1, K2, K3 and the attention backward
    (:func:`record_calls`' output) against its plain version, K1 and K2
    twice for identical bytes, and time it beside its bound and library
    yardstick; fails on a disagreement. Returns (rows, per-kernel sums over
    the call sites, printed with ``label``)."""
    rows, failures = [], []
    with torch.no_grad():
        for key, count, a, k in calls.get("group_norm_silu", ()):
            rtol, atol = TOL["group_norm_silu"]
            kern = lambda a=a, k=k: k_gn.group_norm_silu(*a, **k)  # noqa: E731
            plain = lambda a=a, k=k: k_gn.gn_silu_plain(  # noqa: E731
                a[0], a[1], a[2], k.get("pre_bias"), a[3], k.get("eps", k_gn.GN_EPS))[0]
            got = kern()
            torch.cuda.synchronize()
            max_abs, _, ok = errors(got, plain(), rtol, atol)
            same = bool(torch.equal(got, kern()))
            row = _train_row("group_norm_silu", key, count, max_abs, ok and same,
                             device_ms(torch, kern),
                             device_ms(torch, plain, reps=PLAIN_REPS, warm=PLAIN_WARM), a, k)
            row["repeat_identical"], row["plan"] = same, gn_plan(k_gn, a[0], a[3], False)
            row["torch_seq_ms"] = device_ms(torch, gn_sequence(torch, a, k))
            rows.append(row)
        for key, count, a, k in calls.get("group_norm_silu_bwd", ()):
            kern = lambda a=a: k_gn.group_norm_silu_bwd(*a)  # noqa: E731
            plain = lambda a=a: k_gn.gn_silu_bwd_plain(*a)  # noqa: E731
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            max_abs, ok = 0.0, True
            for name, g_, w_ in zip(("dx", "dgamma", "dbeta", "dbias"), got, want):
                rtol, share = TOL_BWD["dx" if name == "dx" else "vec"]
                e_abs, _, e_ok = scaled_errors(g_, w_, rtol, share)
                max_abs, ok = max(max_abs, e_abs), ok and e_ok and g_.dtype == w_.dtype
            same = all(bool(torch.equal(g_, h_)) for g_, h_ in zip(got, kern()))
            row = _train_row("group_norm_silu_bwd", key, count, max_abs, ok and same,
                             device_ms(torch, kern),
                             device_ms(torch, plain, reps=PLAIN_REPS, warm=PLAIN_WARM), a, k)
            row["repeat_identical"], row["plan"] = same, gn_plan(k_gn, a[0], a[7], True)
            row["torch_seq_ms"] = device_ms(
                torch, gn_sequence(torch, (a[0], a[2], a[3], a[7]), {"pre_bias": a[4]}, a[1]))
            rows.append(row)
        for key, count, a, k in calls.get("attention", ()):
            rtol, atol = TOL["attention"]
            q, kk, v, scale = a
            kern = lambda a=a: k_attn.attention_heads(*a)  # noqa: E731
            plain = lambda a=a: k_attn.attention_heads_plain(*a)  # noqa: E731
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            max_abs, _, ok = errors(got, want, rtol, atol)
            same = bool(torch.equal(got, kern()))
            row = _train_row("attention", key, count, max_abs, ok and same, device_ms(torch, kern),
                             device_ms(torch, plain, reps=PLAIN_REPS, warm=PLAIN_WARM), a, k)
            row["repeat_identical"] = same
            sdpa = lambda q=q, kk=kk, v=v, scale=scale: (  # noqa: E731
                torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2), scale=scale))
            row["library_ms"] = device_ms(torch, sdpa)
            row["plan"] = attention_plan(k_attn, *a[:3])
            rows.append(row)
    for key, count, a, k in calls.get("attention_bwd", ()):
        q, kk, v, g, scale = a

        def kern(a=a):
            with torch.no_grad():
                return k_attn.attention_bwd(*a)

        got = kern()
        leaves = [t.detach().requires_grad_(True) for t in (q, kk, v)]
        out = k_attn.attention_heads_plain(*leaves, scale)
        want = torch.autograd.grad(out, leaves, g, retain_graph=True)
        rel = max(rel_l2(g_, w_) for g_, w_ in zip(got, want))
        max_abs = max(float((g_.float() - w_.float()).abs().max()) for g_, w_ in zip(got, want))
        ok = rel <= ATTN_BWD_REL_L2 and all(bool(g_.isfinite().all()) for g_ in got)
        plain = lambda out=out, leaves=leaves, g=g: torch.autograd.grad(  # noqa: E731
            out, leaves, g, retain_graph=True)
        sl = [t.detach().transpose(1, 2).requires_grad_(True) for t in (q, kk, v)]
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(*sl, scale=scale)
        g_t = g.transpose(1, 2)
        sdpa = lambda o=sdpa_out, sl=sl, g_t=g_t: torch.autograd.grad(  # noqa: E731
            o, sl, g_t, retain_graph=True)
        row = _train_row("attention_bwd", key, count, max_abs, ok, device_ms(torch, kern),
                         device_ms(torch, plain, reps=PLAIN_REPS, warm=PLAIN_WARM), a, k)
        row["rel_l2"], row["library_ms"] = rel, device_ms(torch, sdpa)
        rows.append(row)
    for r in rows:
        print(f"{r['kernel']:20s} {r['key']:52s} sites {r['sites']:2d} "
              f"max_abs {r['max_abs_err']:.3e}"
              + (f" rel_l2 {r['rel_l2']:.3e} (<= {ATTN_BWD_REL_L2})" if "rel_l2" in r else "")
              + f" ms {r['ms']:.4f} plain {r['plain_ms']:.4f} bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})"
              + (f" sdpa {r['library_ms']:.4f}" if r["library_ms"] else "")
              + (f" torch_seq {r['torch_seq_ms']:.4f}" if r.get("torch_seq_ms") else "")
              + (f" repeat {'identical' if r['repeat_identical'] else 'DIFFERENT'}"
                 if "repeat_identical" in r else "")
              + (f" plan {r['plan']}" if r["kernel"].startswith("group_norm") else "")
              + ("" if r["ok"] else "  FAIL"), flush=True)
        if not r["ok"]:
            failures.append(f"{r['kernel']} {r['key']}")
    print(f"tolerances: K1 {TOL['group_norm_silu']}, K3 {TOL['attention']}, K2 dx "
          f"{TOL_BWD['dx']} and dγ/dβ/dbias "
          f"{TOL_BWD['vec']} (rtol, atol as a share of the largest reference value), "
          f"attention backward relative L2 <= {ATTN_BWD_REL_L2}", flush=True)
    if failures:
        fail(f"training kernels disagree with their plain versions: {failures}")
    per_step = {}
    for kname in calls:
        rs = [r for r in rows if r["kernel"] == kname]
        per_step[kname] = {f: sum(r[f] * r["sites"] for r in rs)
                           for f in ("ms", "plain_ms", "bound_ms")}
        per_step[kname]["library_ms"] = (sum(r["library_ms"] * r["sites"] for r in rs)
                                         if kname.startswith("attention") else None)
        if kname.startswith("group_norm"):
            per_step[kname]["torch_seq_ms"] = sum(r["torch_seq_ms"] * r["sites"] for r in rs)
        per_step[kname]["max_abs_err"] = max(r["max_abs_err"] for r in rs)
        per_step[kname]["bound_by"] = max(rs, key=lambda r: r["bound_ms"] * r["sites"])[
            "bound_by"]
        print(f"{label}, {kname}: "
              + ", ".join(f"{f} {v:.4f}" for f, v in per_step[kname].items()
                          if isinstance(v, float)) + f" [{card}]", flush=True)
    return rows, per_step


def gn_plan(k_gn, x, groups, backward: bool) -> dict:
    """K1's (or K2's) plan for the recorded input, as a dict."""
    n, h, w, c = x.shape
    return k_gn.gn_plan(n, h, w, c, groups, k_gn.build.sm_count(x.device), backward,
                        x.element_size())._asdict()


def _train_row(kind, key, count, max_abs, ok, ms, plain_ms, a, k) -> dict:
    row = {"kernel": kind, "key": repr(key), "sites": count, "max_abs_err": max_abs, "ok": ok,
           "ms": ms, "plain_ms": plain_ms, "library_ms": None}
    row["bound_ms"], row["bound_by"] = bound_ms(kind, a, k)
    return row


def ddpm_draws(torch, np):
    """Phase 7's numpy x₀, t, ε at batch 8 (T = 1000)."""
    r = np.random.default_rng(SEED + 2)
    x0 = torch.tensor(np.clip(r.standard_normal((BATCH, 32, 32, 3)), -1, 1).astype(np.float32))
    t = torch.tensor(r.integers(1, 1000, (BATCH,)), dtype=torch.int64)
    eps = torch.tensor(r.standard_normal((BATCH, 32, 32, 3)).astype(np.float32))
    return x0, t, eps


def train_gradient(torch, blocks, init_weights, pair, algo, draws, dev, ops, want: dict,
                   label: str = "training step", forward: bool = False) -> dict:
    """Phase 7 (and the config paths' gradient checks): one
    ``algo.loss_given`` + backward on ``draws`` (x₀, the noise level, the
    noise) in bf16 on the card against f32 on the CPU. ``pair`` is (the
    card's module, the reference module) of one architecture, dropout 0;
    the card's seeded weights (biases and affines drawn, an ε ‖ v head
    conditioned) go into both. The loss and the flattened gradient within
    ``GRAD_REL_L2``, every gradient finite and non-zero on the card, the
    launches ``want``; with ``forward``, one eval forward of each as well,
    within ``UNET_REL_L2`` (its launches counted in ``want``)."""
    from torch.func import functional_call

    card, ref = pair
    init_weights(card, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, card, torch.Generator().manual_seed(SEED + 1))
    weights = {k: v.detach().clone() for k, v in card.state_dict().items()}
    x0, t, eps = draws
    if weights["output_conv.weight"].shape[0] == 2 * x0.shape[-1]:
        weights = condition_var_head(weights)  # ε ‖ v: a well-conditioned variance head
    ref.load_state_dict(weights, strict=True)
    card = card.to(dev)

    def loss_and_grads(model, device):
        params = {k: v.to(device).requires_grad_(True) for k, v in weights.items()}

        def fn(p, x, tt, **kw):
            return functional_call(model, p, (x, tt), kw)

        loss = algo.loss_given(fn, params, x0.to(device), t.to(device), eps.to(device),
                               train=True)
        grads = torch.autograd.grad(loss, list(params.values()))
        y = None
        if forward:
            with torch.no_grad():
                y = fn(params, x0.to(device), t.to(device)).float().cpu()
        return float(loss.detach()), dict(zip(params, (g.float().cpu() for g in grads))), y

    reset_counts(ops)
    loss_c, grads_c, y_c = loss_and_grads(card, dev)
    torch.cuda.synchronize()
    launches = counts(ops)
    print(f"launches in one {label} (loss + backward{' + forward' if forward else ''}): "
          f"{launches} (expected {want})", flush=True)
    expect_bf16_only(label)
    if launches != want:
        fail(f"a {label} launched {launches}, expected {want}")
    bad = [k for k, g in grads_c.items()
           if not bool(g.isfinite().all()) or float(g.abs().max()) == 0.0]
    print(f"parameter tensors with a finite, non-zero gradient on the card: "
          f"{len(grads_c) - len(bad)} of {len(grads_c)}", flush=True)
    if bad:
        fail(f"gradients zero or not finite on the card: {bad[:10]}")
    t0 = time.time()
    loss_r, grads_r, y_r = loss_and_grads(ref, torch.device("cpu"))
    out = {"loss_card": loss_c, "loss_cpu": loss_r, "loss_rel_err": abs(loss_c - loss_r) / abs(loss_r),
           "grad_rel_l2": rel_l2(torch.cat([g.flatten() for g in grads_c.values()]),
                                 torch.cat([grads_r[k].flatten() for k in grads_c])),
           "launches": launches, "per_module": {}, "cpu_s": time.time() - t0,
           "shape": list(x0.shape)}
    for top in dict.fromkeys(k.split(".")[0] for k in grads_c):
        keys = [k for k in grads_c if k.split(".")[0] == top]
        out["per_module"][top] = rel_l2(torch.cat([grads_c[k].flatten() for k in keys]),
                                        torch.cat([grads_r[k].flatten() for k in keys]))
    if forward:
        out["forward_rel_l2"] = rel_l2(y_c, y_r)
    print(f"{label} at {tuple(x0.shape)}: loss card {loss_c:.6f} cpu {loss_r:.6f} rel err "
          f"{out['loss_rel_err']:.3e}; flattened gradient rel L2 {out['grad_rel_l2']:.3e} "
          f"(<= {GRAD_REL_L2})"
          + (f"; forward rel L2 {out['forward_rel_l2']:.3e} (<= {UNET_REL_L2})" if forward else "")
          + f"; the CPU's f32 run {out['cpu_s']:.1f} s; TF32 off for matmul and cuDNN", flush=True)
    print("per top-level module: " + ", ".join(f"{k} {v:.2e}"
                                               for k, v in out["per_module"].items()), flush=True)
    if not (out["grad_rel_l2"] <= GRAD_REL_L2 and out["loss_rel_err"] <= GRAD_REL_L2):
        fail(f"the card's {label} is {out['grad_rel_l2']:.3e} (gradient) and "
             f"{out['loss_rel_err']:.3e} (loss) from the CPU's")
    if forward and not out["forward_rel_l2"] <= UNET_REL_L2:
        fail(f"the card's {label} forward is {out['forward_rel_l2']:.3e} from the CPU's")
    return out


def unet_pair(torch, ddpm_models):
    """Phase 7's (card, reference) pair: the DDPM UNet with both switches,
    dropout 0, bf16 and f32."""
    return tuple(ddpm_models.UNet(dtype=dtype, dropout=0.0, fused_norm=True, fused_block=True)
                 for dtype in (torch.bfloat16, torch.float32))


def timed_steps(torch, np, step, state, batch, card: str, bound_ms_=None,
                batch_size: int = TRAIN_BATCH) -> tuple:
    """``TIMED_STEPS`` steps of ``step`` timed with CUDA events around each
    (no host wait between steps): median, min and max step ms, imgs/s on
    the host clock, peak memory; then three steps under torch.profiler (the
    device's idle share, and a step's time by kernel: a third of theirs).
    ``batch()`` gives a device batch; ``bound_ms_`` is a step's least time
    where known. Returns (state, timing, profile of 3 steps, a step's
    share of it)."""
    torch.cuda.reset_peak_memory_stats()
    batches = [batch() for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    pairs, metrics = [], []
    t0 = time.perf_counter()
    for b in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, b, SEED)
        end.record()
        pairs.append((start, end))
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = [s.elapsed_time(e) for s, e in pairs]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    timing = {"step_ms_median": statistics.median(step_ms), "step_ms_min": min(step_ms),
              "step_ms_max": max(step_ms),
              "imgs_per_sec": batch_size * TIMED_STEPS / wall,
              "imgs_per_sec_from_median": batch_size / (statistics.median(step_ms) / 1e3),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "bound_ms": bound_ms_, "losses": losses, "grad_norms": norms}
    bound = ""
    if bound_ms_ is not None:  # bench.py's work count is the DDPM recipe's
        bound = (f"; step bound {bound_ms_:.2f} ms ({TRAIN_STEP_TFLOP} TFLOP, "
                 f"bench.py:60-63, at {BF16_FLOPS / 1e12:.0f} TFLOP/s)")
    print(f"{TIMED_STEPS} timed steps at batch {batch_size}: step {timing['step_ms_median']:.2f} ms "
          f"median (min {timing['step_ms_min']:.2f}, max {timing['step_ms_max']:.2f}; CUDA "
          f"events), {timing['imgs_per_sec']:.1f} imgs/s (host clock over the run), peak "
          f"memory {timing['peak_mem_gib']:.2f} GiB{bound} [{card}]", flush=True)
    print("losses " + " ".join(f"{v:.4f}" for v in losses), flush=True)
    print("grad_norms " + " ".join(f"{v:.4f}" for v in norms), flush=True)
    if not all(np.isfinite(losses + norms)):
        fail("a timed step gave a loss or grad_norm that is not finite")
    del batches

    # the device's idle share over three steps, and a third of them by kernel
    three = [batch() for _ in range(3)]
    holder = {"state": state}

    def run(bs):
        for b in bs:
            holder["state"], _ = step(holder["state"], b, SEED)

    prof3 = profile_fn(torch, lambda: run(three), top_n=16)
    prof1 = dict(prof3, wall_ms=prof3["wall_ms"] / 3, busy_ms=prof3["busy_ms"] / 3,
                 device_ops=prof3["device_ops"] // 3,
                 top=[(name, ms / 3, count // 3) for name, ms, count in prof3["top"]])
    print(f"3 steps under torch.profiler: wall {prof3['wall_ms']:.2f} ms, device busy "
          f"{prof3['busy_ms']:.2f} ms, idle share {prof3['idle_share']:.3f}", flush=True)
    print(f"a step by kernel (a third of the 3): wall {prof1['wall_ms']:.2f} ms, device busy "
          f"{prof1['busy_ms']:.2f} ms in {prof1['device_ops']} kernels, copies and memsets, "
          f"idle share {prof1['idle_share']:.3f}; against the unprofiled median step "
          f"{1.0 - prof3['busy_ms'] / 3 / timing['step_ms_median']:.3f} [{card}]", flush=True)
    for name, ms, count in prof1["top"]:
        print(f"    {ms:9.3f} ms {count:6d}x  {name}", flush=True)
    return holder["state"], timing, prof3, prof1


def run_fit(torch, np, blocks, dev, ops, report, card: str, lit=None,
            per_step=PER_TRAIN_STEP, key: str = "fit") -> tuple:
    """Phase 8: ``fit`` at the recipe's settings (``lit``, by default
    ``LitDDPM(dtype="bf16")``), then timed and profiled steps of the same
    train step, into ``report[key]``. Returns (lit, state)."""
    import contextlib

    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.parallel import make_train_step
    from dmme_tpu_torch.training import LitDDPM, fit

    if lit is None:
        lit = LitDDPM(dtype="bf16")  # lr 2e-4, warmup 5000, clip 1.0, EMA 0.9999, flips on
    dm = CIFAR10(synthetic=True, batch_size=TRAIN_BATCH)
    log = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(log):
        state = fit(lit, dm, max_steps=FIT_WARM, log_every=1)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    print(f"fit: {FIT_WARM} warm steps (init, first launches) in {warm_s:.1f} s", flush=True)

    # one step of the same train step, its updates checked
    step = make_train_step(lit.make_loss_fn(dm))
    it = dm.train_iter(SEED + 7)

    def batch():
        return torch.from_numpy(next(it)).pin_memory().to(dev, non_blocking=True)

    p0 = {k: v.clone() for k, v in state.params.items()}
    e0 = {k: v.clone() for k, v in state.ema_params.items()}
    lr = lit.make_optimizer().schedule(state.opt_state.count)
    state, m = step(state, batch(), SEED)
    deltas = torch.cat([(state.params[k] - p0[k]).abs().flatten() for k in p0])
    unmoved = [k for k in p0 if torch.equal(state.params[k], p0[k])]
    ema_err = max(float(((state.ema_params[k] - (lit.decay * e0[k] + (1 - lit.decay)
                                                 * state.params[k])).abs()
                         / (e0[k].abs() + 1e-12)).max()) for k in e0)
    upd = {"lr": lr, "max_abs_dp": float(deltas.max()), "median_abs_dp": float(deltas.median()),
           "unmoved_tensors": len(unmoved), "ema_max_rel_err": ema_err}
    print(f"one step at lr {lr:.4e}: max |Δp| {upd['max_abs_dp']:.3e}, median |Δp| "
          f"{upd['median_abs_dp']:.3e}, tensors unmoved {len(unmoved)}; EMA = "
          f"decay·ema + (1−decay)·p to {ema_err:.2e} relative", flush=True)
    if unmoved or not (upd["max_abs_dp"] <= 10 * lr and 0.1 * lr <= upd["median_abs_dp"] <= 2 * lr
                       and ema_err <= 1e-5):
        fail(f"the step did not move parameters and EMA by the expected amounts: {upd}")
    del p0, e0

    reset_counts(ops)
    log = io.StringIO()
    with contextlib.redirect_stderr(log):
        state = fit(lit, dm, max_steps=state.step + FIT_STEPS, state=state, log_every=1)
    torch.cuda.synchronize()
    launches = counts(ops)
    expect_bf16_only("fit")
    lines = [ln for ln in log.getvalue().splitlines() if ln.startswith("[step")]
    for ln in lines:
        print("  " + ln, flush=True)
    logged = [dict(kv.split("=") for kv in ln.split("] ", 1)[1].split()) for ln in lines]
    bad = [r for r in logged if not all(np.isfinite(float(r[f])) for f in ("loss", "grad_norm"))]
    expect = {k: v * FIT_STEPS for k, v in per_step.items()}
    print(f"fit: {len(logged)} logged steps; launches {launches} (expected {expect})", flush=True)
    if len(logged) != FIT_STEPS or bad:
        fail(f"fit logged {len(logged)} steps, {len(bad)} with a loss or grad_norm not finite")
    if launches != expect:
        fail(f"fit launched {launches}, expected {expect}")

    bound_ms_ = 1e3 * TRAIN_STEP_TFLOP * 1e12 / BF16_FLOPS if key == "fit" else None
    state, timing, prof3, prof1 = timed_steps(torch, np, step, state, batch, card, bound_ms_)
    report[key] = {"warm_s": warm_s, "update": upd, "logged": logged, "launches": launches,
                   "timing": timing, "profile_3_steps": prof3, "profile_1_step": prof1}
    return lit, state


def sample_after_training(torch, k_res, lit, state, dev, ops) -> dict:
    """Phase 9: DDIM-50 n = 8 from the trained raw weights through K4, equal
    byte for byte after K4's weight cache is cleared."""
    from dmme_tpu_torch.training import LitDDIM

    ddim = LitDDIM(model=lit.model)  # T=1000, DDIM-50, quadratic τ

    def draw():
        gen = torch.Generator(device=dev).manual_seed(11)
        return ddim.generate(state, gen, (8, 32, 32, 3), use_ema=False)

    reset_counts(ops)
    a = draw()
    torch.cuda.synchronize()
    launches = counts(ops)
    expect_bf16_only("sampling after training")
    k_res._PACKED.clear()
    b = draw()
    torch.cuda.synchronize()
    same = bool(torch.equal(a, b))
    ok = same and tuple(a.shape) == (8, 32, 32, 3) and bool(a.isfinite().all())
    print(f"DDIM-50 n=8 from the trained raw weights: shape {tuple(a.shape)}, std "
          f"{float(a.std()):.4f}, launches {launches}; after clearing K4's weight cache: "
          f"{'identical bytes' if same else 'DIFFERENT'}", flush=True)
    if launches["resblock"] != 22 * ddim.diffusion_model.sub_timesteps:
        fail(f"sampling launched {launches}, expected 22 K4 calls per step")
    if not ok:
        fail("sampling after training is not repeatable through K4's weight cache")
    return {"launches": launches, "identical": same}


def _rows_report(rows, title: str) -> None:
    """Print one line a checked call; fail if any disagreed."""
    for r in rows:
        print(f"{r['kernel']:20s} {r['key']:60s} max_abs {r['max_abs_err']:.3e}"
              + ("" if r["ok"] else "  FAIL"), flush=True)
    failures = [f"{r['kernel']} {r['key']}" for r in rows if not r["ok"]]
    if failures:
        fail(f"{title}: kernels disagree with their plain versions: {failures}")


def offpath_kernels(torch, k_gn, k_attn, k_res, dev) -> list:
    """Phase 6b: K1, K2, K3 and K4 at shapes off the main path, random
    inputs from a seed, each held against its plain version on the card
    (K1 and K2 also called twice for identical bytes)."""
    gen = torch.Generator().manual_seed(SEED + 20)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=gen)).to(device=dev, dtype=dtype)

    rows = []
    with torch.no_grad():
        # K1 and K2: C/G = 3, a 12x12 image, C = 1024, and samples that no
        # cluster holds (two passes); per-sample affines and pre-biases; in
        # bf16, fp16 and f32 (the latter two within TOL_SIMT)
        for dtype, (n, h, w, c, per_sample, with_bias) in (
                (dt, shape) for dt in (torch.bfloat16, torch.float16, torch.float32)
                for shape in ((4, 8, 8, 96, True, True), (2, 12, 12, 64, False, True),
                              (2, 16, 16, 1024, True, False), (3, 32, 32, 512, True, True),
                              (2, 64, 64, 256, False, True), (1, 256, 256, 128, True, True))):
            aff = (n, c) if per_sample else (c,)
            x = rnd(n, h, w, c, dtype=dtype)
            gamma, beta = 1.0 + rnd(*aff, scale=0.1), rnd(*aff, scale=0.1)
            bias = rnd(n, c, scale=0.5) if with_bias else None
            key = repr((str(dtype)[6:], (n, h, w, c), per_sample, with_bias))
            got = k_gn.group_norm_silu_fwd(x, gamma, beta, 32, pre_bias=bias)
            again = k_gn.group_norm_silu_fwd(x, gamma, beta, 32, pre_bias=bias)
            max_abs, ok = _gn_errors(got, k_gn.gn_silu_plain(x, gamma, beta, bias, 32))
            same = all(bool(torch.equal(u, v)) for u, v in zip(got, again))
            rows.append({"kernel": "group_norm_silu", "key": key, "max_abs_err": max_abs,
                         "ok": ok and same, "repeat_identical": same,
                         "plan": gn_plan(k_gn, x, 32, False)})
            dz = rnd(n, h, w, c, dtype=dtype)
            args = (x, dz, gamma, beta, bias, got[1], got[2], 32)
            got, again = k_gn.group_norm_silu_bwd(*args), k_gn.group_norm_silu_bwd(*args)
            max_abs, ok = _gn_errors(got, k_gn.gn_silu_bwd_plain(*args))
            same = all(bool(torch.equal(u, v)) for u, v in zip(got, again))
            rows.append({"kernel": "group_norm_silu_bwd", "key": key, "max_abs_err": max_abs,
                         "ok": ok and same, "repeat_identical": same,
                         "plan": gn_plan(k_gn, x, 32, True)})
        # K3: head dims off the 64-wide panels, 512, ragged T, a key split at a
        # padded head dim; q, k, v strided views of a packed projection; in
        # bf16, fp16 and f32 (the 3xTF32 kernel: D = 512 in halves of 16-key
        # tiles, its own key split), the latter two within TOL_SIMT
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            for n, t, hh, d in ((2, 100, 4, 16), (2, 100, 4, 48), (2, 100, 2, 96),
                                (1, 1024, 1, 96), (2, 100, 2, 160), (2, 77, 1, 512),
                                (1, 64, 1, 512), (1, 256, 1, 512)):
                qkv = rnd(n, t, 3, hh, d, dtype=dtype)
                q, kk, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
                scale = (hh * d) ** -0.5
                got = k_attn.attention_heads(q, kk, v, scale)
                max_abs, ok = _offpath_errors(
                    got, k_attn.attention_heads_plain(q, kk, v, scale), "attention")
                same = bool(torch.equal(got, k_attn.attention_heads(q, kk, v, scale)))
                rows.append({"kernel": "attention", "key": repr((str(dtype)[6:], n, t, hh, d)),
                             "max_abs_err": max_abs, "ok": ok and same, "repeat_identical": same,
                             "plan": attention_plan(k_attn, q, kk, v)})
        # K4: C_in 32 and 96, C_out 32, 64 and 192, H x W that whole 64-pixel
        # rows do not tile (6x6, 12x20), identity and projection skips; in
        # bf16, fp16 and f32 (3xTF32: 32-channel K steps, partial at 96 + 32)
        for dtype, (n, h, w, cin, cout) in (
                (dt, shape) for dt in (torch.bfloat16, torch.float16, torch.float32)
                for shape in ((2, 8, 8, 32, 64), (2, 8, 8, 96, 192), (2, 6, 6, 64, 64),
                              (1, 12, 20, 128, 128), (2, 8, 8, 32, 32), (1, 16, 16, 96, 64),
                              (2, 8, 8, 40, 72))):
            x = rnd(n, h, w, cin, dtype=dtype)
            g1, b1v = 1.0 + rnd(n, cin, scale=0.1), rnd(n, cin, scale=0.1)
            pre2, g2, b2v = rnd(n, cout, scale=0.5), 1.0 + rnd(n, cout, scale=0.1), rnd(
                n, cout, scale=0.1)
            w1, w2 = rnd(cout, cin, 3, 3, scale=(9 * cin) ** -0.5), rnd(
                cout, cout, 3, 3, scale=(9 * cout) ** -0.5)
            b1, b2 = rnd(cout, scale=0.1), rnd(cout, scale=0.1)
            wr, br = ((rnd(cout, cin, 1, 1, scale=cin ** -0.5), rnd(cout, scale=0.1))
                      if cin != cout else (None, None))
            pa = (x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, wr, br, 32, k_gn.GN_EPS)
            groups = 8 if cin % 32 or cout % 32 else 32
            pa = pa[:12] + (groups, k_gn.GN_EPS)
            got = k_res.resblock_forward(*pa[:10], wr=wr, br=br, num_groups=groups)
            max_abs, ok = _offpath_errors(got, k_res.resblock_plain(*pa), "resblock")
            same = bool(torch.equal(got, k_res.resblock_forward(*pa[:10], wr=wr, br=br,
                                                                num_groups=groups)))
            p1 = k_res.conv_plan(n, h, w, cin, cout, 0, k_res.build.sm_count(dev),
                                 x.element_size())
            rows.append({"kernel": "resblock",
                         "key": repr((str(dtype)[6:], (n, h, w, cin), cout, wr is not None)),
                         "max_abs_err": max_abs, "ok": ok and same, "repeat_identical": same,
                         "plan": p1._asdict()})
    torch.cuda.synchronize()
    _rows_report(rows, "off-path shapes")
    print(f"off-path shapes: {len(rows)} calls within TOL {TOL} and K2 {TOL_BWD} (K1's mean "
          f"and inverse std within {TOL_BWD['vec']}; K1–K4 in fp16 and f32 within TOL_SIMT "
          f"{TOL_SIMT}); every call repeats byte for byte", flush=True)
    return rows


def _gn_errors(got, want) -> tuple:
    """(max abs error, ok) of K1's (y, mean, inv) or K2's (dx, dγ, dβ, dbias)
    against the plain version's: with bf16 activations y within ``TOL``, dx
    and the f32 statistics and sums within ``TOL_BWD`` (atol a share of the
    largest reference value); with fp16 or f32 ones every output within that
    dtype's ``TOL_SIMT``, as :func:`wide_rows` holds them."""
    dt = str(got[0].dtype)
    max_abs, ok = 0.0, True
    for i, (g, w) in enumerate(zip(got, want)):
        if dt in TOL_SIMT:
            rtol, share, least = TOL_SIMT[dt]
            e, _, o = errors(g, w, rtol, max(share * float(w.float().abs().max()), least))
        elif i == 0 and len(got) == 3:
            e, _, o = errors(g, w, *TOL["group_norm_silu"])
        else:
            e, _, o = scaled_errors(g, w, *TOL_BWD["dx" if i == 0 else "vec"])
        max_abs, ok = max(max_abs, e), ok and o and g.dtype == w.dtype
    return max_abs, ok


def simt_kernels(torch, k_gn, dev, ops) -> list:
    """Phase 6c: K1 and K2 at widths outside ``group_norm.cu``'s domain in
    bf16, fp16 and f32. Each call must launch ``simt.cu`` once (its counter
    moves by one, no other counter moves), agree with its plain version
    (:func:`_gn_errors`) and repeat byte for byte."""
    gen = torch.Generator().manual_seed(SEED + 25)

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=gen)).to(device=dev, dtype=dtype)

    rows = []
    with torch.no_grad():
        for dtype, (n, h, w, c, groups) in (
                (dt, shape) for dt in (torch.bfloat16, torch.float16, torch.float32)
                for shape in ((2, 8, 8, 12, 4), (2, 6, 6, 4, 2), (1, 8, 8, 2056, 8))):
            x, dz = rnd(n, h, w, c, dtype=dtype), rnd(n, h, w, c, dtype=dtype)
            gamma, beta = 1.0 + rnd(n, c, scale=0.1), rnd(c, scale=0.1)
            bias = rnd(n, c, scale=0.5)
            key = repr((str(dtype)[6:], (n, h, w, c), groups))
            for kind in ("group_norm_silu", "group_norm_silu_bwd"):
                if kind == "group_norm_silu":
                    args = (x, gamma, beta, groups)
                    run = lambda: k_gn.group_norm_silu_fwd(*args, pre_bias=bias)  # noqa: E731
                    want = k_gn.gn_silu_plain(x, gamma, beta, bias, groups)
                else:
                    args = (x, dz, gamma, beta, bias, want[1], want[2], groups)
                    run = lambda: k_gn.group_norm_silu_bwd(*args)  # noqa: E731
                    want = k_gn.gn_silu_bwd_plain(*args)
                reset_counts(ops)
                got = run()
                torch.cuda.synchronize()
                launched = {"bf16": counts(ops), **wide_counts()}
                moved = {f"{r} {k}": v for r, d in launched.items() for k, v in d.items() if v}
                max_abs, ok = _gn_errors(got, want)
                same = all(bool(torch.equal(u, v)) for u, v in zip(got, run()))
                rows.append({"kernel": kind, "key": key, "max_abs_err": max_abs,
                             "launched": moved, "repeat_identical": same,
                             "ok": ok and same and moved == {f"simt {kind}": 1}})
    torch.cuda.synchronize()
    _rows_report(rows, "simt.cu widths")
    print(f"simt.cu widths: {len(rows)} calls, each one launch of simt.cu and no other kernel, "
          f"within TOL/TOL_BWD (bf16) and TOL_SIMT {TOL_SIMT}; every call repeats byte for byte",
          flush=True)
    return rows


def _offpath_errors(got, want, kind: str) -> tuple:
    """(max abs error, ok): bf16 within ``TOL[kind]``, fp16 and f32 within
    ``TOL_SIMT`` (atol a share of the largest reference value)."""
    if got.dtype == want.dtype and str(got.dtype) in TOL_SIMT:
        rtol, share, least = TOL_SIMT[str(got.dtype)]
        max_abs, _, ok = errors(got, want, rtol, max(share * float(want.float().abs().max()),
                                                      least))
    else:
        max_abs, _, ok = errors(got, want, *TOL[kind])
    return max_abs, ok and got.dtype == want.dtype


def lsun_forward(torch, blocks, ddpm_models, init_weights, k_gn, k_attn, k_res, ops,
                 dev) -> dict:
    """Phase 4b: one UNet forward at the LSUN widths at batch 1, both switches
    on: every K1, K3 and K4 call held against its plain version on its
    recorded inputs, then the bf16 output against the same module and
    weights in f32 on the CPU."""
    m = ddpm_models.UNet(dtype=torch.bfloat16, fused_norm=True, fused_block=True, **LSUN_WIDTHS)
    init_weights(m, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, m, torch.Generator().manual_seed(SEED + 1))
    ref = ddpm_models.UNet(dtype=torch.float32, fused_norm=True, fused_block=True, **LSUN_WIDTHS)
    ref.load_state_dict(m.state_dict(), strict=True)
    m = m.to(dev).eval()
    gen = torch.Generator().manual_seed(SEED + 30)
    x = torch.randn((1, LSUN_IMG, LSUN_IMG, 3), generator=gen)
    t = torch.randint(1, 1000, (1,), generator=gen)
    with torch.no_grad():
        reset_counts(ops)
        out = {}
        calls = record_calls(serve_targets(blocks),
                             lambda: out.setdefault("y", m(x.to(dev), t.to(dev))))
        torch.cuda.synchronize()
        launches = counts(ops)
        expect_bf16_only("LSUN-width forward")
        rows = []
        plain = {"group_norm_silu": lambda a, k: k_gn.gn_silu_plain(
                     a[0], a[1], a[2], k.get("pre_bias"), a[3], k.get("eps", k_gn.GN_EPS))[0],
                 "attention": lambda a, k: k_attn.attention_heads_plain(*a, **k),
                 "resblock": lambda a, k: k_res.resblock_plain(
                     *a, k.get("wr"), k.get("br"), k.get("num_groups", 32),
                     k.get("eps", k_gn.GN_EPS))}
        kernel = {"group_norm_silu": k_gn.group_norm_silu, "attention": k_attn.attention_heads,
                  "resblock": k_res.resblock_forward}
        for kind_, lst in calls.items():
            for key, count, a, k in lst:
                max_abs, _, ok = errors(kernel[kind_](*a, **k), plain[kind_](a, k), *TOL[kind_])
                rows.append({"kernel": kind_, "key": repr(key), "sites": count,
                             "max_abs_err": max_abs, "ok": ok})
        _rows_report(rows, "LSUN widths")
        want = ref(x, t)
    got = out["y"].float().cpu()
    rel = rel_l2(got, want)
    ok = bool(got.isfinite().all()) and got.shape == want.shape and rel <= UNET_REL_L2
    sites = {k: sum(c for _, c, _, _ in v) for k, v in calls.items()}
    print(f"LSUN widths, batch 1, {LSUN_IMG}x{LSUN_IMG}: shape {tuple(got.shape)} rel_l2 "
          f"{rel:.3e} (<= {UNET_REL_L2}) launches {launches} call sites {sites}"
          + ("" if ok else "  FAIL"), flush=True)
    if not ok:
        fail("UNet forward at the LSUN widths disagrees with the f32 CPU reference")
    if {k: launches[k] for k in sites} != sites:
        fail(f"the LSUN forward launched {launches} for call sites {sites}")
    return {"rel_l2": rel, "launches": launches, "sites": sites, "shapes": rows}


def wide_rows(torch, k_gn, k_attn, k_res, calls, dtype) -> list:
    """The f32 or fp16 kernels at every recorded call site (K1 and K2 of
    ``group_norm.cu``, K3 and K4 on the tensor cores), each held against its
    plain version on the same inputs (``TOL_SIMT``, atol a share of the
    largest reference value), timed, bounded, and called twice for identical
    bytes. Beside K3, SDPA on the same inputs; beside K4, the cuDNN sequence;
    beside K1 and K2, ``F.group_norm`` + ``F.silu`` (its autograd for K2)
    and the plan (``scripts/torch_gn_plans.py`` times the plans and
    ``simt.cu`` there); in f32, K3's and K4's bound at the f32 CUDA-core rate too
    (``bound_cores_ms``), beside the 3xTF32 one."""
    rtol, share, least = TOL_SIMT[str(dtype)]
    rows = []
    with torch.no_grad():
        for kind, lst in calls.items():
            for key, count, a, k in lst:
                pa = None
                if kind == "group_norm_silu":
                    kern = lambda a=a, k=k: k_gn.group_norm_silu(*a, **k)  # noqa: E731
                    plain = lambda a=a, k=k: k_gn.gn_silu_plain(  # noqa: E731
                        a[0], a[1], a[2], k.get("pre_bias"), a[3], k.get("eps", k_gn.GN_EPS))[0]
                    seq = gn_sequence(torch, a, k)
                elif kind == "group_norm_silu_bwd":
                    kern = lambda a=a: k_gn.group_norm_silu_bwd(*a)  # noqa: E731
                    plain = lambda a=a: k_gn.gn_silu_bwd_plain(*a)  # noqa: E731
                    seq = gn_sequence(torch, (a[0], a[2], a[3], a[7]), {"pre_bias": a[4]}, a[1])
                elif kind == "attention":
                    kern = lambda a=a: k_attn.attention_heads(*a)  # noqa: E731
                    plain = lambda a=a: k_attn.attention_heads_plain(*a)  # noqa: E731
                elif kind == "resblock":
                    pa = list(a) + [k.get("wr"), k.get("br"), k.get("num_groups", 32),
                                    k.get("eps", k_gn.GN_EPS)]
                    kern = lambda a=a, k=k: k_res.resblock_forward(*a, **k)  # noqa: E731
                    plain = lambda pa=pa: k_res.resblock_plain(*pa)  # noqa: E731
                else:  # the attention backward is torch ops in every dtype
                    continue
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                got, want = ((got, want) if isinstance(got, tuple) else ((got,), (want,)))
                max_abs, ok = 0.0, True
                for g_, w_ in zip(got, want):
                    atol = max(share * float(w_.float().abs().max()), least)
                    e_abs, _, e_ok = errors(g_, w_, rtol, atol)
                    max_abs, ok = max(max_abs, e_abs), ok and e_ok and g_.dtype == w_.dtype
                again = kern()
                same = all(bool(torch.equal(g_, h_)) for g_, h_ in
                           zip(got, again if isinstance(again, tuple) else (again,)))
                row = _train_row(kind, key, count, max_abs, ok and same, device_ms(torch, kern),
                                 device_ms(torch, plain, reps=PLAIN_REPS, warm=PLAIN_WARM), a, k)
                row["repeat_identical"] = same
                if kind == "attention":
                    q, kk, v, scale = a
                    row["library_ms"] = device_ms(
                        torch, lambda q=q, kk=kk, v=v, scale=scale:
                        torch.nn.functional.scaled_dot_product_attention(
                            q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2),
                            scale=scale))
                    row["plan"] = attention_plan(k_attn, q, kk, v)
                elif kind == "resblock":
                    try:
                        row["cudnn_seq_ms"] = device_ms(torch, cudnn_sequence(torch, pa))
                    except RuntimeError as err:  # a yardstick only: note it and go on
                        row["cudnn_seq_ms"] = None
                        print(f"cudnn sequence at {key}: {err}", flush=True)
                if kind in ("attention", "resblock") and dtype == torch.float32:
                    row["bound_cores_ms"] = bound_ms(kind, a, k, F32_FLOPS)[0]
                if kind.startswith("group_norm"):
                    backward = kind == "group_norm_silu_bwd"
                    row["plan"] = gn_plan(k_gn, a[0], a[7] if backward else a[3], backward)
                    row["torch_seq_ms"] = device_ms(torch, seq)
                rows.append(row)
    for r in rows:
        print(f"{str(dtype)[6:]:8s} {r['kernel']:20s} {r['key']:52s} sites {r['sites']:2d} "
              f"max_abs {r['max_abs_err']:.3e} ms {r['ms']:.4f} plain {r['plain_ms']:.4f} "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']})"
              + (f" cores bound {r['bound_cores_ms']:.4f}" if r.get("bound_cores_ms") else "")
              + (f" sdpa {r['library_ms']:.4f}" if r["library_ms"] else "")
              + (f" cudnn_seq {r['cudnn_seq_ms']:.4f}" if r.get("cudnn_seq_ms") else "")
              + (f" torch_seq {r['torch_seq_ms']:.4f} plan {r['plan']}"
                 if "torch_seq_ms" in r else "")
              + (" token-major" if r.get("plan", {}).get("trans") else "")
              + f" repeat {'identical' if r['repeat_identical'] else 'DIFFERENT'}"
              + ("" if r["ok"] else "  FAIL"), flush=True)
    bad = [f"{r['kernel']} {r['key']}" for r in rows if not r["ok"]]
    if bad:
        fail(f"the {dtype} kernels disagree with their plain versions (rtol {rtol}, atol "
             f"{share} of the largest reference value, at least {least}): {bad}")
    return rows


def per_site_sum(rows, kind: str) -> dict:
    """Times and bounds of ``kind``'s rows summed over their call sites."""
    rs = [r for r in rows if r["kernel"] == kind]
    out = {f: sum(r[f] * r["sites"] for r in rs) for f in ("ms", "plain_ms", "bound_ms")}
    out["library_ms"] = (sum(r["library_ms"] * r["sites"] for r in rs)
                         if kind == "attention" else None)
    out["max_abs_err"] = max(r["max_abs_err"] for r in rs)
    out["bound_by"] = max(rs, key=lambda r: r["bound_ms"] * r["sites"])["bound_by"]
    # the library sequences beside K1, K2 and K4, and K3's and K4's f32
    # CUDA-core bound, where every row has one
    for seq in ("torch_seq_ms", "cudnn_seq_ms", "bound_cores_ms"):
        if rs and all(r.get(seq) is not None for r in rs):
            out[seq] = sum(r[seq] * r["sites"] for r in rs)
    return out


def _print_per_path(name: str, per_path: dict, card: str) -> None:
    for kind, v in per_path.items():
        print(f"{name} {kind} summed over its call sites: ms {v['ms']:.4f} plain "
              f"{v['plain_ms']:.4f} bound {v['bound_ms']:.4f} ({v['bound_by']})"
              + (f" cores bound {v['bound_cores_ms']:.4f}" if v.get("bound_cores_ms") else "")
              + (f" sdpa {v['library_ms']:.4f}" if v["library_ms"] else "")
              + (f" cudnn_seq {v['cudnn_seq_ms']:.4f}" if v.get("cudnn_seq_ms") else "")
              + (f" torch_seq {v['torch_seq_ms']:.4f}" if v.get("torch_seq_ms") else "")
              + f" [{card}]", flush=True)


def harness_timing(torch, dtype: str, dev) -> dict:
    """``scripts/torch_f32_time.py:time_dtype`` on this checkout's package:
    the ``LitDDPM(dtype=...)`` step (median of ``HARNESS_TIMED_STEPS``) and a
    DDIM-50 request at n = 8."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_f32_time.py")
    spec = importlib.util.spec_from_file_location("torch_f32_time", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.time_dtype(torch, dtype, dev, steps=HARNESS_TIMED_STEPS)


def f32_phase(torch, np, blocks, init_weights, k_gn, k_attn, k_res, dev, ops,
              card: str, gn_only: bool = False) -> dict:
    """Phase 10: the default harness in f32 (fault C.5), then fp16. For each
    dtype, one full-width ``LitDDPM`` training step at batch 128 and one
    ``LitDDIM`` DDIM step at n = 8 on the card, launching K1/K2/K3 (45/45/6)
    and K1/K3/K4 (1/6/22): K1 and K2 of ``group_norm.cu``, K3 and K4 on the
    tensor cores in that dtype, and no bf16 or ``simt.cu`` kernel; every call site held against its
    plain version (:func:`wide_rows`). Then, dropout off, the loss and
    gradient of one step and one UNet forward (the DDIM step's ε prediction)
    on the same weights and inputs against f32 on the CPU: f32 within
    ``F32_REL_L2``, fp16's forward within ``UNET_REL_L2``; the bf16 harness on
    the same weights and inputs is the control that must miss ``F32_REL_L2``.
    The DDIM step's output is held to the same limits. Last, each dtype's
    default harness timed (``scripts/torch_f32_time.py:time_dtype``): the
    training step's median ms, device busy and idle share, and one DDIM-50
    request at n = 8. With ``gn_only`` (``--kernels-only``): each dtype's
    training step and its K1 and K2 rows, nothing else."""
    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.parallel import make_train_step
    from dmme_tpu_torch.training import LitDDIM, LitDDPM

    want_train = {"group_norm_silu": 45, "group_norm_silu_bwd": 45, "attention": 6,
                  "resblock": 0}
    want_ddim = {"group_norm_silu": 1, "group_norm_silu_bwd": 0, "attention": 6, "resblock": 22}
    none = {k: 0 for k in ops}
    r = np.random.default_rng(SEED + 40)
    x0 = torch.tensor(np.clip(r.standard_normal((CPU_REF_BATCH, 32, 32, 3)), -1, 1),
                      dtype=torch.float32)
    t = torch.tensor(r.integers(1, 1000, (CPU_REF_BATCH,)), dtype=torch.int64)
    eps = torch.tensor(r.standard_normal((CPU_REF_BATCH, 32, 32, 3)), dtype=torch.float32)
    xs = torch.tensor(r.standard_normal((BATCH, 32, 32, 3)), dtype=torch.float32)
    ts = torch.full((BATCH,), 980, dtype=torch.int64)
    dm = CIFAR10(synthetic=True, synthetic_size=2 * TRAIN_BATCH, batch_size=TRAIN_BATCH)
    dm.setup("fit")
    batch = torch.from_numpy(next(dm.train_iter(SEED))).to(dev)
    weights = None
    out = {}

    def measure(lit, device):
        """Loss and flat gradient of one step (dropout off), the UNet's ε
        prediction at (xs, ts) and one DDIM step from xs, on ``device``."""
        params = {k: v.to(device).requires_grad_(True) for k, v in weights.items()}
        loss = lit.diffusion_model.loss_given(lit.model_fn, params, x0.to(device), t.to(device),
                                              eps.to(device), train=True)
        grads = torch.autograd.grad(loss, list(params.values()))
        ddim = LitDDIM(model=lit.model)  # the same module, T=1000, DDIM-50
        with torch.no_grad():
            p = {k: v.detach() for k, v in params.items()}
            pred = lit.model_fn(p, xs.to(device), ts.to(device))
            step = ddim.diffusion_model.sampling_step(ddim.model_fn, p, xs.to(device), 50)
        return {"loss": loss.detach().cpu(),
                "grad": torch.cat([g.detach().float().flatten().cpu() for g in grads]),
                "pred": pred.float().cpu(), "step": step.float().cpu()}

    def readings(got, ref) -> dict:
        return {"loss_rel_err": float(abs(got["loss"] - ref["loss"]) / abs(ref["loss"])),
                "grad_rel_l2": rel_l2(got["grad"], ref["grad"]),
                "pred_rel_l2": rel_l2(got["pred"], ref["pred"]),
                "step_rel_l2": rel_l2(got["step"], ref["step"])}

    ref = None
    for name in ("f32", "fp16"):
        lit = LitDDPM() if name == "f32" else LitDDPM(dtype="fp16")  # dropout 0.1
        dtype = lit.model.dtype
        if weights is None:
            init_weights(lit.model, torch.Generator().manual_seed(SEED))
            randomize_affines(torch, blocks, lit.model, torch.Generator().manual_seed(SEED + 1))
            weights = {k: v.detach().clone() for k, v in lit.model.state_dict().items()}
        state = lit.init_state(SEED, device=dev)
        with torch.no_grad():
            for k, v in state.params.items():
                v.copy_(weights[k])
        step_fn = make_train_step(lit.make_loss_fn(dm))
        metrics = {}

        def train(state=state, step_fn=step_fn):
            metrics.update(step_fn(state, batch, SEED)[1])
            torch.cuda.synchronize()

        reset_counts(ops)
        calls = record_calls(train_targets(blocks, k_gn, k_attn), train)
        loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
        rec = {"dtype": str(dtype), "train": {"loss": loss, "grad_norm": grad_norm,
                                              "launches": counts(ops), "wide": wide_counts()}}
        print(f"LitDDPM({'' if name == 'f32' else 'dtype=' + repr(name)}) one training step at "
              f"batch {TRAIN_BATCH} on the card ({dtype}): loss {loss:.6f} grad_norm "
              f"{grad_norm:.4f}; bf16 kernel launches {rec['train']['launches']}; f32/fp16 "
              f"launches {rec['train']['wide']}", flush=True)
        if not (np.isfinite(loss) and np.isfinite(grad_norm)):
            fail(f"the {name} training step gave a loss or grad_norm that is not finite")
        if (rec["train"]["launches"] != none
                or rec["train"]["wide"] != wide_expected(name, want_train)):
            fail(f"the {name} step launched {rec['train']['launches']} bf16 and "
                 f"{rec['train']['wide']} f32/fp16 kernels, expected none and "
                 f"{wide_expected(name, want_train)}")
        if gn_only:
            rec["rows"] = wide_rows(torch, k_gn, k_attn, k_res, {
                k: v for k, v in calls.items() if k.startswith("group_norm")}, dtype)
            rec["per_path"] = {kind: per_site_sum(rec["rows"], kind)
                               for kind in ("group_norm_silu", "group_norm_silu_bwd")}
            _print_per_path(name, rec["per_path"], card)
            out[name] = rec
            del lit, state, calls
            torch.cuda.empty_cache()
            continue

        for mod in lit.model.modules():  # dropout off: the card and the CPU draw other masks
            if isinstance(mod, blocks.ResBlock):
                mod.dropout = 0.0
        lit.model.to(dev)
        ddim = LitDDIM(model=lit.model)
        p_dev = {k: v.to(dev) for k, v in weights.items()}
        reset_counts(ops)
        with torch.no_grad():
            sample_calls = record_calls(
                serve_targets(blocks),
                lambda: ddim.diffusion_model.sampling_step(ddim.model_fn, p_dev, xs.to(dev), 50))
        torch.cuda.synchronize()
        rec["ddim_step"] = {"launches": counts(ops), "wide": wide_counts()}
        print(f"LitDDIM() one DDIM step at n={BATCH} ({dtype}): bf16 kernel launches "
              f"{rec['ddim_step']['launches']}; f32/fp16 launches {rec['ddim_step']['wide']}",
              flush=True)
        if (rec["ddim_step"]["launches"] != none
                or rec["ddim_step"]["wide"] != wide_expected(name, want_ddim)):
            fail(f"the {name} DDIM step launched {rec['ddim_step']['launches']} bf16 and "
                 f"{rec['ddim_step']['wide']} f32/fp16 kernels, expected none and "
                 f"{wide_expected(name, want_ddim)}")
        rows = wide_rows(torch, k_gn, k_attn, k_res, calls, dtype)
        rows_ddim = wide_rows(torch, k_gn, k_attn, k_res, sample_calls, dtype)
        del calls, sample_calls
        rec["rows"], rec["rows_ddim"] = rows, rows_ddim
        # K1, K2 and K3 summed over a training step's call sites; K4 over a
        # DDIM forward's at n = 8
        rec["per_path"] = {kind: per_site_sum(rows, kind)
                           for kind in ("group_norm_silu", "group_norm_silu_bwd", "attention")}
        rec["per_path"]["resblock"] = per_site_sum(rows_ddim, "resblock")
        _print_per_path(name, rec["per_path"], card)

        reset_counts(ops)
        got = measure(lit, dev)
        torch.cuda.synchronize()
        if not all(bool(v.isfinite().all()) for v in got.values()):
            fail(f"the {name} step, forward or DDIM step on the card is not finite")
        if ref is None:
            cpu = LitDDPM()
            cpu.model.load_state_dict(weights)
            for mod in cpu.model.modules():
                if isinstance(mod, blocks.ResBlock):
                    mod.dropout = 0.0
            ref = measure(cpu, torch.device("cpu"))
        rec["vs_cpu"] = readings(got, ref)
        # fp16 without loss scaling: gradients of order 1/numel fall below
        # fp16's normal range, so its loss and gradient are reported, not held
        held = (("loss_rel_err", "grad_rel_l2", "pred_rel_l2", "step_rel_l2") if name == "f32"
                else ("pred_rel_l2", "step_rel_l2"))
        limit = F32_REL_L2 if name == "f32" else UNET_REL_L2
        print(f"{name} card vs f32 CPU: " + ", ".join(f"{k} {v:.3e}"
                                                     for k, v in rec["vs_cpu"].items())
              + f" ({', '.join(held)} <= {limit})", flush=True)
        if not all(rec["vs_cpu"][k] <= limit for k in held):
            fail(f"the {name} harness on the card disagrees with the f32 CPU reference")
        out[name] = rec
        del lit, state, p_dev
        torch.cuda.empty_cache()
        rec["timing"] = harness_timing(torch, name, dev)
        print(f"LitDDPM({name!r}): step {rec['timing']['step_ms']:.3f} ms median of "
              f"{HARNESS_TIMED_STEPS} (device "
              f"busy {rec['timing']['step_busy_ms']:.3f} ms, idle share "
              f"{rec['timing']['step_idle_share']:.3f}); DDIM-50 n=8 request "
              f"{rec['timing']['request_s']:.3f} s (device busy "
              f"{rec['timing']['request_busy_ms']:.3f} ms, idle share "
              f"{rec['timing']['request_idle_share']:.3f}) [{card}]", flush=True)
        torch.cuda.empty_cache()

    if gn_only:
        return out
    # the control: the bf16 harness on the same weights and inputs, through the
    # same comparison, must miss F32_REL_L2 (the f32 check would see bf16 compute)
    lit = LitDDPM(dtype="bf16")
    lit.model.load_state_dict(weights)
    for mod in lit.model.modules():
        if isinstance(mod, blocks.ResBlock):
            mod.dropout = 0.0
    lit.model.to(dev)
    out["bf16_control"] = readings(measure(lit, dev), ref)
    print("bf16 control, card vs f32 CPU: " + ", ".join(
        f"{k} {v:.3e}" for k, v in out["bf16_control"].items())
        + f" (the f32 limit {F32_REL_L2} must reject the gradient and the forward)", flush=True)
    if not (out["bf16_control"]["grad_rel_l2"] > F32_REL_L2
            and out["bf16_control"]["pred_rel_l2"] > F32_REL_L2):
        fail("the f32 comparison does not tell bf16 compute from f32")
    return out


# configs/iddpm/cifar10.yaml's harness: T = 4000 linear β in [2.5e-5, 5e-3],
# the hybrid loss with γ = 0.001, lr 1e-4, warmup 5000, EMA 0.9999
IDDPM_CIFAR = dict(lr=1e-4, warmup=5000, decay=0.9999, schedule="linear", timesteps=4000,
                   start=0.000025, end=0.005, loss_type="hybrid", gamma=0.001)
# launches of one IDDPM training step and one eval forward (both switches on)
PER_TRAIN_STEP_IDDPM = {"group_norm_silu": 45, "group_norm_silu_bwd": 45, "attention": 11,
                        "resblock": 0}
PER_FORWARD_IDDPM = {"group_norm_silu": 1, "group_norm_silu_bwd": 0, "attention": 11,
                     "resblock": 22}
# the variance head: channels 3-5 of the IDDPM UNet's output conv (ε ‖ v)
VAR_HEAD = slice(3, 6)
# At random weights v ≈ 0 ± 0.5, and at t = 1 (β̃ = 0, clamped to 1e-12) the
# learned variance exp(v·log β_1 + (1 − v)·log 1e-12) has σ ≈ 1e-8 to 1e-4,
# far below the 1/255 bins of the discretized NLL. A pixel whose mean lies
# within a few σ of a bin edge has a bin mass that is the difference of two
# CDF values a few f32 ulps below 1; an ulp of the mean or of erf (cuDNN
# against the CPU) moves it by tens of percent, or across the 1e-12 clamp,
# and its gradient d(−log p)/d log σ ≈ z² ≈ 25 outweighs a bulk KL pixel's
# O(1). The variance head's gradient is then ill-conditioned in f32 itself.
# The held reading sets the head so that v ≈ 1.2 ± 0.02 (σ at t = 1 ≈ 0.3):
# the t = 1 sample stays in the batch and its NLL well-conditioned.
VAR_HEAD_COND = (0.01, 1.2)  # (scale of the head's kernel, added to its bias)


def iddpm_model(torch, blocks, init_weights, dtype, **kw):
    """The IDDPM UNet of configs/iddpm/cifar10.yaml (36,168,070 parameters,
    FiLM, 4 heads at depths 2 and 3, ε ‖ v), both switches on, with the
    seed's weights and every bias and GroupNorm affine drawn at random."""
    from dmme_tpu_torch.models import iddpm as iddpm_models

    m = iddpm_models.UNet(dtype=dtype, fused_norm=True, fused_block=True, **kw)
    init_weights(m, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, m, torch.Generator().manual_seed(SEED + 1))
    return m


def condition_var_head(weights: dict, conv: str = "output_conv") -> dict:
    """``weights`` with the variance head of the output conv ``conv`` set
    per ``VAR_HEAD_COND``."""
    scale, shift = VAR_HEAD_COND
    out = dict(weights)
    w, b = weights[f"{conv}.weight"].clone(), weights[f"{conv}.bias"].clone()
    w[VAR_HEAD] *= scale
    b[VAR_HEAD] += shift
    out[f"{conv}.weight"], out[f"{conv}.bias"] = w, b
    return out


def iddpm_kernels(torch, blocks, k_gn, k_attn, k_res, build, init_weights, dev, ops,
                  card: str) -> dict:
    """Phase 11: K1, K3 and K4 at every call site of full-width IDDPM forwards
    at n = 1, 8 and 16 (FiLM: per-sample GN2 affines at K4's 22 sites, 4-head
    attention at head dims 64 and 32), and K1, K2, K3 and the attention
    backward at every call site of one training step at batch 128, each held
    against its plain version, timed and bounded; launches 1/11/22 a forward
    and 45/45/11/0 a step, no f32 or fp16 launch."""
    import functools

    from dmme_tpu_torch.training import LitIDDPM

    m = iddpm_model(torch, blocks, init_weights, torch.bfloat16).to(dev).eval()
    runs = {}
    for n in SERVE_BATCHES:
        g = torch.Generator().manual_seed(SEED + 50 + n)
        runs[f"n{n}"] = (m, torch.randn((n, 32, 32, 3), generator=g),
                         torch.randint(1, 4000, (n,), generator=g), PER_FORWARD_IDDPM)
    reset_counts(ops)
    recorded, sites = record_forwards(torch, blocks, runs, dev)
    torch.cuda.synchronize()
    launches = counts(ops)
    expect_bf16_only("IDDPM forwards")
    print(f"IDDPM call sites per forward: {json.dumps(sites)}; launches of the "
          f"{len(runs)} forwards {launches}", flush=True)
    want = {k: v * len(runs) for k, v in PER_FORWARD_IDDPM.items()}
    if launches != want:
        fail(f"the IDDPM forwards launched {launches}, expected {want}")
    rows, failures = forward_rows(torch, k_gn, k_attn, k_res, build, dev, recorded)
    if failures:
        fail(f"IDDPM forward kernels disagree with their plain versions: {failures}")
    del m, recorded
    torch.cuda.empty_cache()
    n8 = [dict(r, sites=r["sites"]["n8"]) for r in rows if "n8" in r["sites"]]
    per_forward = {kname: per_site_sum(n8, kname)
                   for kname in ("group_norm_silu", "attention", "resblock")}
    for kname, v in per_forward.items():
        print(f"per IDDPM forward at n = {BATCH}, {kname}: " + ", ".join(
            f"{f} {x:.4f}" for f, x in v.items() if isinstance(x, float)) + f" [{card}]",
            flush=True)
    lit = functools.partial(LitIDDPM, **IDDPM_CIFAR)
    train = train_kernels(torch, blocks, k_gn, k_attn, None, init_weights, lit, dev, card, ops)
    return {"forward_rows": rows, "sites": sites, "forward_launches": launches,
            "per_forward": per_forward, "train": train}


def _dropout_masks(blocks, model, record: dict, replay: bool):
    """Patch each ResBlock of ``model`` to record the dropout mask it draws
    (``replay=False``) or to run on the mask recorded for it (``replay=True``,
    through the block's own ``mask``/``recompute`` arguments, as its remat
    recomputation does). Returns the undo function."""
    patched = []
    for name, blk in model.named_modules():
        if not isinstance(blk, blocks.ResBlock):
            continue
        if replay:
            def fwd(x, emb, train=False, generator=None, _b=blk, _n=name, **kw):
                return type(_b).forward(_b, x, emb, train, None,
                                        mask=record[_n].to(x.device), recompute=True)
            blk.forward = fwd
            patched.append((blk, "forward"))
        else:
            def std(x, emb, mask, whole=None, spatial=None, _b=blk, _n=name):
                record[_n] = mask.cpu()
                return type(_b)._standard(_b, x, emb, mask, whole, spatial)
            blk._standard = std
            patched.append((blk, "_standard"))

    def undo():
        for blk, attr in patched:
            delattr(blk, attr)
    return undo


def iddpm_gradient(torch, np, blocks, init_weights, dev, ops) -> dict:
    """Phase 12: one hybrid-loss ``loss_given`` + backward of the IDDPM UNet
    at batch 8 with T = 4000 (configs/iddpm/cifar10.yaml), dropout 0.3 on:
    bf16 on the card against f32 on the CPU on the same weights, numpy t
    (one sample at t = 1, the discretized-NLL branch), ε, and the dropout
    masks the card drew, replayed on the CPU. The loss and the flattened
    gradient within ``GRAD_REL_L2``; the variance head (channels 3-5 of
    ``output_conv``) reported apart; launches 45/45/11/0."""
    from torch.func import functional_call

    from dmme_tpu_torch.diffusion import IDDPM

    card = iddpm_model(torch, blocks, init_weights, torch.bfloat16)
    ref = iddpm_model(torch, blocks, init_weights, torch.float32)
    ref.load_state_dict(card.state_dict(), strict=True)
    card = card.to(dev)
    algo = IDDPM.create(**{k: IDDPM_CIFAR[k] for k in ("timesteps", "loss_type", "gamma",
                                                        "schedule", "start", "end")})
    r = np.random.default_rng(SEED + 3)
    x0 = torch.tensor(np.clip(r.standard_normal((BATCH, 32, 32, 3)), -1, 1).astype(np.float32))
    t = torch.tensor(r.integers(1, algo.timesteps, (BATCH,)), dtype=torch.int64)
    t[0] = 1
    eps = torch.tensor(r.standard_normal((BATCH, 32, 32, 3)).astype(np.float32))
    masks = {}

    def loss_and_grads(model, device, replay, w):
        params = {k: v.detach().to(device).requires_grad_(True) for k, v in w.items()}
        undo = _dropout_masks(blocks, model, masks, replay)
        try:
            loss = algo.loss_given(
                lambda p, x, tt, **kw: functional_call(model, p, (x, tt), kw), params,
                x0.to(device), t.to(device), eps.to(device), train=True,
                generator=torch.Generator(device=device).manual_seed(SEED))
            grads = torch.autograd.grad(loss, list(params.values()))
        finally:
            undo()
        return loss.detach().cpu(), dict(zip(params, (g.cpu() for g in grads)))

    weights = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    reset_counts(ops)
    loss_c, grads_c = loss_and_grads(card, dev, False, weights)
    torch.cuda.synchronize()
    launches = counts(ops)
    expect_bf16_only("IDDPM training step")
    print(f"IDDPM hybrid loss_given + backward at batch {BATCH}: launches {launches}; "
          f"t {t.tolist()}; {len(masks)} dropout masks recorded", flush=True)
    if launches != PER_TRAIN_STEP_IDDPM:
        fail(f"an IDDPM training step launched {launches}, expected {PER_TRAIN_STEP_IDDPM}")
    bad = [k for k, g in grads_c.items()
           if not bool(g.isfinite().all()) or float(g.abs().max()) == 0.0]
    if bad:
        fail(f"IDDPM gradients zero or not finite on the card: {bad[:10]}")
    loss_r, grads_r = loss_and_grads(ref, torch.device("cpu"), True, weights)

    def var_head(grads):
        return torch.cat([grads[f"output_conv.{p}"][VAR_HEAD].float().flatten()
                          for p in ("weight", "bias")])

    out = {"loss_card": float(loss_c), "loss_cpu": float(loss_r),
           "loss_rel_err": abs(float(loss_c) - float(loss_r)) / abs(float(loss_r)),
           "grad_rel_l2": rel_l2(torch.cat([g.float().flatten() for g in grads_c.values()]),
                                 torch.cat([grads_r[k].flatten() for k in grads_c])),
           "var_head_rel_l2": rel_l2(var_head(grads_c), var_head(grads_r)),
           "launches": launches, "t": t.tolist(), "per_module": {}}
    for top in dict.fromkeys(k.split(".")[0] for k in grads_c):
        keys = [k for k in grads_c if k.split(".")[0] == top]
        out["per_module"][top] = rel_l2(torch.cat([grads_c[k].float().flatten() for k in keys]),
                                        torch.cat([grads_r[k].flatten() for k in keys]))
    # the same step with the variance head conditioned (VAR_HEAD_COND), masks
    # drawn again on the card and replayed
    cond = condition_var_head(weights)
    _, cond_c = loss_and_grads(card, dev, False, cond)
    _, cond_r = loss_and_grads(ref, torch.device("cpu"), True, cond)
    out["var_head_rel_l2_conditioned"] = rel_l2(var_head(cond_c), var_head(cond_r))
    print(f"IDDPM loss card {out['loss_card']:.6f} cpu {out['loss_cpu']:.6f} rel err "
          f"{out['loss_rel_err']:.3e}; flattened gradient rel L2 {out['grad_rel_l2']:.3e} "
          f"(<= {GRAD_REL_L2}); variance head (output_conv channels 3-5) rel L2 "
          f"{out['var_head_rel_l2']:.3e}, {out['var_head_rel_l2_conditioned']:.3e} with the "
          f"head conditioned (both reported)", flush=True)
    print("per top-level module: " + ", ".join(f"{k} {v:.2e}"
                                               for k, v in out["per_module"].items()), flush=True)
    if not (out["loss_rel_err"] <= GRAD_REL_L2 and out["grad_rel_l2"] <= GRAD_REL_L2):
        fail(f"the card's IDDPM loss or gradient is too far from the CPU's: {out}")
    return out


def _post(url: str, body: dict):
    """POST /sample; returns (status, body bytes, seconds)."""
    req = urllib.request.Request(url + "/sample", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.time()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read(), time.time() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.time() - t0


def _serve(torch, sampler):
    """A started server for ``sampler``: (url, stop)."""
    from dmme_tpu_torch.serving import make_server

    server = make_server(sampler, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    return "http://%s:%d" % server.server_address[:2], stop


def default_requests(np, url: str, ops, model: str, card: str) -> tuple:
    """``default`` requests of n = 1, 8, 16 and a repeat of 8 that must return
    identical bytes, after one warm request (cuDNN plans, first buffers).
    Returns (one record a request, the launches of the four)."""
    _post(url, {"n": 1, "seed": 99, "format": "npy"})
    reset_counts(ops)
    requests, bodies = [], {}
    for n, seed in ((1, 1), (8, 2), (16, 3), (8, 2)):
        code, data, secs = _post(url, {"n": n, "seed": seed, "format": "npy"})
        imgs = np.load(io.BytesIO(data)) if code == 200 else None
        ok = bool(code == 200 and imgs.shape == (n, 32, 32, 3) and np.isfinite(imgs).all()
                  and imgs.min() >= 0.0 and imgs.max() <= 1.0)
        requests.append({"n": n, "seed": seed, "s": secs, "ok": ok,
                         "mean": float(imgs.mean()) if ok else None,
                         "std": float(imgs.std()) if ok else None})
        print(f"{model}: POST /sample n={n:2d} seed={seed}: {secs:.3f} s"
              + (f", range [{imgs.min():.3f}, {imgs.max():.3f}], std {imgs.std():.4f}"
                 if ok else "  FAIL") + f" [{card}]", flush=True)
        if not ok:
            fail(f"{model}: /sample n={n} returned bad images")
        if (n, seed) in bodies and bodies[(n, seed)] != data:
            fail(f"{model}: a repeated request with the same seed returned other bytes")
        bodies[(n, seed)] = data
    launches = counts(ops)
    expect_bf16_only(f"{model} serve")
    print(f"{model}: repeat of n=8 seed=2 identical bytes", flush=True)
    return requests, launches


def launches_for(per_forward: dict, forwards: int, partial: dict = None, key_every: int = 1):
    """Kernel launches of a run of ``forwards`` network evaluations: every
    one full (``per_forward``), or, with ``partial``, one in ``key_every``
    full (a key step, counted from the first) and the rest partial."""
    keys = -(-forwards // key_every) if partial is not None else forwards
    rest = forwards - keys
    return {k: v * keys + (partial[k] * rest if partial is not None else 0)
            for k, v in per_forward.items()}


def solver_requests(np, url: str, ops, model: str, card: str, samplers) -> list:
    """Requests at n = 8, one a sampler, each repeated for identical bytes
    and its launches held: ``samplers`` lists (name, steps or None for the
    sampler's default, the launches the request must make)."""
    out = []
    for name, steps, want in samplers:
        body = {"n": BATCH, "seed": 2, "format": "npy", "sampler": name}
        if steps is not None:
            body["steps"] = steps
        reset_counts(ops)
        code, data, secs = _post(url, body)
        launches = counts(ops)
        code2, again, secs2 = _post(url, body)
        imgs = np.load(io.BytesIO(data)) if code == 200 else None
        ok = bool(code == code2 == 200 and data == again and imgs.shape == (BATCH, 32, 32, 3)
                  and np.isfinite(imgs).all() and imgs.min() >= 0.0 and imgs.max() <= 1.0)
        out.append({"model": model, "sampler": name, "steps": steps, "s": secs, "s_repeat": secs2,
                    "launches": launches, "ok": ok,
                    "std": float(imgs.std()) if imgs is not None else None})
        print(f"{model}: POST /sample sampler={name} (steps {steps}) n={BATCH}: {secs:.3f} s, "
              f"repeat {secs2:.3f} s {'identical' if data == again else 'DIFFERENT'}, launches "
              f"{launches} [{card}]" + ("" if ok else "  FAIL"), flush=True)
        if not ok:
            fail(f"{model}: the {name} request failed or was not repeatable")
        expect_bf16_only(f"{model} {name} request")
        if launches != want:
            fail(f"{model} {name} launched {launches}, expected {want}")
    return out


def rejected(url: str, model: str, name: str, needle: str) -> dict:
    """A request the model's family does not take: 400, naming why."""
    code, data, _ = _post(url, {"n": 1, "sampler": name, "format": "npy"})
    err = json.loads(data).get("error")
    print(f"{model} sampler={name}: {code} {err}", flush=True)
    if code != 400 or needle not in err:
        fail(f"{model} sampler={name} answered {code} {data!r}")
    return {"code": code, "error": err}


def iddpm_serve(torch, np, blocks, dev, ops, card: str) -> dict:
    """Phase 14: ``LitIDDPM(dtype="bf16", sample_steps=50)`` (T = 1000,
    cosine) behind ``make_server``: ``default`` requests (the 50-step
    respaced ancestral sampler with learned variances) at n = 1, 8 and 16
    and a repeat of 8 with identical bytes, launches 1/11/22 a forward;
    ``ddim``/``dpm``/``unipc`` at n = 8 (ε-only adapter, clip_x0 on the
    cosine schedule); ``cached`` answered 400 (variance-learning models
    have no ε-only decoder to cache); one n = 8 ``default`` request
    under torch.profiler; 20 steps of the T = 4000 ancestral loop of
    configs/iddpm/cifar10.yaml timed and extrapolated."""
    from dmme_tpu_torch.serving import SAMPLERS, Sampler
    from dmme_tpu_torch.training import LitIDDPM, TrainState

    lit = LitIDDPM(dtype="bf16", sample_steps=50)
    lit.init_state(SEED)
    randomize_affines(torch, blocks, lit.model, torch.Generator().manual_seed(SEED + 1))
    state = TrainState.create({k: v.detach().clone() for k, v in lit.model.state_dict().items()},
                              lit.make_optimizer())
    sampler = Sampler(lit, state, img_size=32, device=dev)
    url, stop = _serve(torch, sampler)
    out = {}
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        print(f"healthz {health}", flush=True)
        if health.get("samplers") != list(SAMPLERS):
            fail(f"healthz: {health}")
        out["requests"], launches = default_requests(np, url, ops, "IDDPM", card)
        want = {k: v * 50 * 4 for k, v in PER_FORWARD_IDDPM.items()}
        print(f"IDDPM: launches during the four default requests {launches} (expected {want})",
              flush=True)
        if launches != want:
            fail(f"IDDPM serve launched {launches}, expected {want}")
        out["launches"] = launches
        out["solvers"] = solver_requests(np, url, ops, "IDDPM", card, [
            (name, steps, launches_for(PER_FORWARD_IDDPM, steps)) for name, steps in SOLVERS])
        out["cached"] = rejected(url, "IDDPM", "cached", "variance-learning")
    finally:
        stop()
    prof = profile_fn(torch, lambda: sampler.sample(BATCH, seed=5))
    out["profile_n8"] = prof
    print(f"IDDPM default n=8 under torch.profiler: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['busy_ms']:.2f} ms, idle share {prof['idle_share']:.3f} [{card}]", flush=True)
    for name, ms, count in prof["top"]:
        print(f"    {ms:9.3f} ms {count:6d}x  {name}", flush=True)

    # the T = 4000 ancestral loop of configs/iddpm/cifar10.yaml: 20 steps timed
    full = LitIDDPM(model=lit.model, **IDDPM_CIFAR)
    x = torch.randn((BATCH, 32, 32, 3), generator=torch.Generator().manual_seed(SEED)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    algo, params = full.diffusion_model.to(dev), sampler.state.ema_params
    with torch.no_grad():
        x = algo.sampling_step(full.model_fn, params, x, 4000, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(3999, 3979, -1):
            x = algo.sampling_step(full.model_fn, params, x, t, gen)
        torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / 20
    out["t4000"] = {"step_s": per_step, "request_s_extrapolated": 4000 * per_step,
                    "finite": bool(x.isfinite().all())}
    print(f"T = 4000 ancestral sampling at n = {BATCH}: {1e3 * per_step:.3f} ms a step (20 "
          f"steps, host clock), so {4000 * per_step:.1f} s a request [{card}]", flush=True)
    if not out["t4000"]["finite"]:
        fail("the T = 4000 ancestral steps are not finite")
    return out


def f32_iddpm_phase(torch, np, blocks, init_weights, k_gn, k_attn, k_res, dev, ops,
                    card: str) -> dict:
    """Phase 16: ``LitIDDPM()`` (f32, T = 1000 cosine, dropout 0.3) takes one
    full-width training step at batch 128 and one 50-step respaced step at
    n = 8 on the card (K1/K2/K3 45/45/11 a step, K1/K3/K4 1/11/22 a forward:
    K1 and K2 of ``group_norm.cu``, K3 and K4 in f32 on the tensor cores, no
    bf16 kernel), every call site held against its
    plain version (:func:`wide_rows`). Then, dropout off, the hybrid
    ``loss_given`` at batch ``CPU_REF_BATCH`` (t from the seed, one sample
    at t = 1) with its gradient
    and the respaced step (injected noise) against f32 on the CPU, within
    ``F32_REL_L2``, the variance head's gradient included; the bf16 harness
    on the same inputs is the control that must miss that limit."""
    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.parallel import make_train_step
    from dmme_tpu_torch.training import LitIDDPM

    none = {k: 0 for k in ops}
    want_step = PER_TRAIN_STEP_IDDPM
    r = np.random.default_rng(SEED + 60)
    x0 = torch.tensor(np.clip(r.standard_normal((CPU_REF_BATCH, 32, 32, 3)), -1, 1),
                      dtype=torch.float32)
    t = torch.tensor(r.integers(1, 1000, (CPU_REF_BATCH,)), dtype=torch.int64)
    t[0] = 1
    eps = torch.tensor(r.standard_normal((CPU_REF_BATCH, 32, 32, 3)), dtype=torch.float32)
    xs = torch.tensor(r.standard_normal((BATCH, 32, 32, 3)), dtype=torch.float32)
    noise = torch.tensor(r.standard_normal((BATCH, 32, 32, 3)), dtype=torch.float32)
    dm = CIFAR10(synthetic=True, synthetic_size=2 * TRAIN_BATCH, batch_size=TRAIN_BATCH)
    dm.setup("fit")
    batch = torch.from_numpy(next(dm.train_iter(SEED))).to(dev)

    lit = LitIDDPM()
    weights = {k: v.detach().clone() for k, v in iddpm_model(
        torch, blocks, init_weights, torch.float32).state_dict().items()}
    state = lit.init_state(SEED, device=dev)
    with torch.no_grad():
        for k, v in state.params.items():
            v.copy_(weights[k])
    metrics = {}

    def train():
        metrics.update(make_train_step(lit.make_loss_fn(dm))(state, batch, SEED)[1])
        torch.cuda.synchronize()

    reset_counts(ops)
    calls = record_calls(train_targets(blocks, k_gn, k_attn), train)
    out = {"train": {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                     "launches": counts(ops), "wide": wide_counts()}}
    print(f"LitIDDPM() one training step at batch {TRAIN_BATCH} (f32): loss "
          f"{out['train']['loss']:.6f} grad_norm {out['train']['grad_norm']:.4f}; bf16 kernel "
          f"launches {out['train']['launches']}; f32/fp16 launches {out['train']['wide']}",
          flush=True)
    if not (np.isfinite(out["train"]["loss"]) and np.isfinite(out["train"]["grad_norm"])):
        fail("the f32 IDDPM training step is not finite")
    if out["train"]["launches"] != none or out["train"]["wide"] != wide_expected("f32", want_step):
        fail(f"the f32 IDDPM step launched {out['train']['launches']} bf16 and "
             f"{out['train']['wide']} f32/fp16 kernels, expected none and "
             f"{wide_expected('f32', want_step)}")
    del state

    for mod in lit.model.modules():  # dropout off: the card and the CPU draw other masks
        if isinstance(mod, blocks.ResBlock):
            mod.dropout = 0.0
    lit.model.to(dev)
    strided = lit.diffusion_model.strided(50)
    p_dev = {k: v.to(dev) for k, v in weights.items()}
    reset_counts(ops)
    with torch.no_grad():
        sample_calls = record_calls(serve_targets(blocks), lambda: strided.sampling_step(
            lit.model_fn, p_dev, xs.to(dev), 50, noise=noise.to(dev)))
    torch.cuda.synchronize()
    out["strided_step"] = {"launches": counts(ops), "wide": wide_counts()}
    want_fwd = wide_expected("f32", PER_FORWARD_IDDPM)
    print(f"LitIDDPM() one respaced step at n={BATCH} (f32): bf16 kernel launches "
          f"{out['strided_step']['launches']}; f32/fp16 launches {out['strided_step']['wide']}",
          flush=True)
    if out["strided_step"]["launches"] != none or out["strided_step"]["wide"] != want_fwd:
        fail(f"the f32 respaced step launched {out['strided_step']}, expected {want_fwd}")
    rows = wide_rows(torch, k_gn, k_attn, k_res, calls, torch.float32)
    rows_fwd = wide_rows(torch, k_gn, k_attn, k_res, sample_calls, torch.float32)
    del calls, sample_calls
    out["rows"], out["rows_fwd"] = rows, rows_fwd
    out["per_path"] = {kind: per_site_sum(rows, kind)
                       for kind in ("group_norm_silu", "group_norm_silu_bwd", "attention")}
    out["per_path"]["resblock"] = per_site_sum(rows_fwd, "resblock")
    _print_per_path("f32 IDDPM", out["per_path"], card)

    def measure(harness, device, w):
        params = {k: v.to(device).requires_grad_(True) for k, v in w.items()}
        loss = harness.diffusion_model.loss_given(harness.model_fn, params, x0.to(device),
                                                  t.to(device), eps.to(device), train=True)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        with torch.no_grad():
            p = {k: v.detach() for k, v in params.items()}
            step = strided.sampling_step(harness.model_fn, p, xs.to(device), 50,
                                         noise=noise.to(device))
        var_head = torch.cat([grads[f"output_conv.{n}"][VAR_HEAD].flatten()
                              for n in ("weight", "bias")])
        return {"loss": loss.detach().cpu(),
                "grad": torch.cat([g.detach().float().flatten().cpu() for g in grads.values()]),
                "var_head": var_head.detach().float().cpu(), "step": step.float().cpu()}

    def readings(got, ref) -> dict:
        return {"loss_rel_err": float(abs(got["loss"] - ref["loss"]) / abs(ref["loss"])),
                "grad_rel_l2": rel_l2(got["grad"], ref["grad"]),
                "var_head_rel_l2": rel_l2(got["var_head"], ref["var_head"]),
                "step_rel_l2": rel_l2(got["step"], ref["step"])}

    def harness(dtype):
        h = LitIDDPM(dtype=dtype)
        for mod in h.model.modules():
            if isinstance(mod, blocks.ResBlock):
                mod.dropout = 0.0
        return h

    cpu, control = harness("f32"), harness("bf16")
    control.model.to(dev)
    conditioned = condition_var_head(weights)
    for name, w in (("as drawn", weights), ("v-head conditioned", conditioned)):
        got = measure(lit, dev, w)
        torch.cuda.synchronize()
        if not all(bool(v.isfinite().all()) for v in got.values()):
            fail("the f32 IDDPM loss, gradient or respaced step on the card is not finite")
        ref = measure(cpu, torch.device("cpu"), w)
        rec = out.setdefault(name, {})
        rec["vs_cpu"] = readings(got, ref)
        rec["bf16_control"] = readings(measure(control, dev, w), ref)
        # as drawn, the t = 1 NLL is ill-conditioned in f32 (VAR_HEAD_COND):
        # its variance-head reading is reported, the rest held
        held = [k for k in rec["vs_cpu"] if name != "as drawn" or k != "var_head_rel_l2"]
        print(f"f32 IDDPM ({name}) card vs f32 CPU: " + ", ".join(
            f"{k} {v:.3e}" for k, v in rec["vs_cpu"].items()) + f" ({', '.join(held)} <= "
            f"{F32_REL_L2}); bf16 control: " + ", ".join(
            f"{k} {v:.3e}" for k, v in rec["bf16_control"].items()), flush=True)
        if not all(rec["vs_cpu"][k] <= F32_REL_L2 for k in held):
            fail(f"the f32 IDDPM harness ({name}) on the card disagrees with the f32 CPU "
                 "reference")
        if not rec["bf16_control"]["grad_rel_l2"] > F32_REL_L2:
            fail("the f32 IDDPM comparison does not tell bf16 compute from f32")
    return out


CLI_ROOT = os.path.join("build", "cli_run")
# the procedural Shapes images a CLI run renders: enough for the steps it
# takes (the configs render 50,000 at 32 px, 20,000 at 64 and 2,048 at 256,
# which took ≈ 6, 12 and 18 s a run on an H100 host, PERF.md)
SHAPES_CUT = ["--data.init_args.size", "4096"]
#: the checkpoint, log and grid cadence of the CLI and CFG fits: a fit of
#: two cadences, resumed to three against an uninterrupted run of three
CLI_CADENCE = 5


def _cli_callback(root: str, every: int = 10) -> str:
    """GenerateImage every ``every`` steps into ``<root>/samples``, as a YAML
    value that replaces the config's callback list."""
    return ("[{class_path: dmme_tpu.callbacks.GenerateImage, init_args: {imgsize: [3, 32, 32], "
            f"every_n_steps: {every}, out_dir: {root}/samples}}}}]")


def _jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def cli_run(torch, ops, card: str, name: str, argv, want=None) -> dict:
    """``dmme_tpu_torch.trainer.main(argv)`` in this process: its wall time
    and launches, none of them of an f32 or fp16 kernel, and ``want`` if
    given."""
    from dmme_tpu_torch.trainer import main as cli

    reset_counts(ops)
    torch.cuda.synchronize()
    t0 = time.time()
    cli(argv)
    torch.cuda.synchronize()
    rec = {"wall_s": time.time() - t0, "launches": counts(ops), "wide": wide_counts()}
    print(f"{name}: {rec['wall_s']:.2f} s wall, launches {rec['launches']}, f32/fp16 "
          f"launches {rec['wide']} [{card}]", flush=True)
    if any(v for d in rec["wide"].values() for v in d.values()):
        fail(f"{name}: a bf16 path launched the f32/fp16 kernels")
    if want is not None and rec["launches"] != want:
        fail(f"{name} launched {rec['launches']}, expected {want}")
    return rec


def state_differences(torch, a: dict, b: dict) -> list:
    """The tensors (parameters, EMA, Adam moments) in which two saved states differ."""
    return [f"{part}.{k}" for part, x, y in (
        ("params", a["params"], b["params"]), ("ema_params", a["ema_params"], b["ema_params"]),
        ("mu", a["opt_state"]["mu"], b["opt_state"]["mu"]),
        ("nu", a["opt_state"]["nu"], b["opt_state"]["nu"])) for k in x
        if not torch.equal(x[k], y[k])]


def cli_phase(torch, np, ops, dev, card: str) -> dict:
    """Phase 9b: the command line in this process (so the counters read its
    launches), ``dmme_tpu_torch.trainer.main``, on the repo's configs: fit at
    full width with checkpoints, JSONL, TensorBoard and GenerateImage grids;
    a resume to step 3k against an uninterrupted 3k-step run, bit for bit
    (k = ``CLI_CADENCE``); sample and predict from the resumed checkpoint, predict against
    ``generate`` on a state restored in place; the Shapes recipe in chunks
    of 10 steps. (Whether remat lowers the peak memory at the LSUN and the
    ImageNet-64 widths is held in phases 53 and 54 on those configs' own
    UNets: :func:`remat_peaks`.)"""
    import shutil

    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.callbacks import GenerateImage
    from dmme_tpu_torch.parallel.train_step import step_generator
    from dmme_tpu_torch.training import CheckpointManager
    from dmme_tpu_torch.utils.norm import denorm

    torch.backends.cudnn.deterministic = True
    print("cudnn deterministic on for the CLI phase", flush=True)
    roots = {k: os.path.join("build", k) for k in ("cli_run", "cli_run_whole", "cli_shapes",
                                                      "cli_iddpm_shapes", "cli_iddpm_sample")}
    for root in roots.values():
        shutil.rmtree(root, ignore_errors=True)
    ddim_cfg = ["--config", "configs/ddim/cifar10.yaml", "--data.init_args.synthetic", "true"]
    k = CLI_CADENCE
    fit_args = ddim_cfg + ["--trainer.ckpt_every_n_steps", str(k), "--trainer.log_every_n_steps",
                           str(k), "--trainer.tensorboard", "true"]
    out = {}
    sample_steps = 50

    def run(name, argv, want=None):
        out[name] = cli_run(torch, ops, card, name, argv, want)
        return out[name]

    def fit_launches(steps, generations):
        """K1/K2/K3 per training step and K1/K3/K4 per DDIM-50 forward of the grids."""
        fwd = sample_steps * generations
        return {"group_norm_silu": 45 * steps + fwd, "group_norm_silu_bwd": 45 * steps,
                "attention": 6 * steps + 6 * fwd, "resblock": 22 * fwd}

    root = roots["cli_run"]
    rec = run(f"fit {2 * k}", ["fit", *fit_args, "--trainer.max_steps", str(2 * k),
                               "--trainer.default_root_dir", root,
                               "--trainer.callbacks", _cli_callback(root, k)],
              fit_launches(2 * k, 3))
    logged = _jsonl(os.path.join(root, "metrics.jsonl"))
    step_ms = [1e3 * TRAIN_BATCH / r["imgs_per_sec"] for r in logged]
    rec["logged_steps"], rec["step_ms_from_jsonl"] = [r["step"] for r in logged], step_ms
    grids = sorted(os.listdir(os.path.join(root, "samples")))
    tb = [f for f in os.listdir(os.path.join(root, "tb")) if f.startswith("events.out")]
    rec.update(checkpoints=CheckpointManager(root).steps(), grids=grids, tb_files=tb)
    print(f"fit {2 * k}: checkpoints {rec['checkpoints']}, JSONL steps {rec['logged_steps']} "
          f"(losses {[round(r['loss'], 5) for r in logged]}), TensorBoard {tb}, grids {grids}; "
          f"step ms "
          f"from the JSONL imgs_per_sec {[round(v, 2) for v in step_ms]} (median "
          f"{statistics.median(step_ms):.2f}; a window holds the checkpoint and grid of its "
          f"first step) [{card}]", flush=True)
    if (rec["checkpoints"] != [k, 2 * k] or rec["logged_steps"] != [k, 2 * k] or len(tb) != 1
            or grids != [f"step_{k:08d}.png", f"step_{2 * k:08d}.png"]
            or not all(np.isfinite(r["loss"]) for r in logged)):
        fail(f"fit through the CLI left {rec}")

    run(f"resume {2 * k} -> {3 * k}", ["fit", *fit_args, "--trainer.max_steps", str(3 * k),
                                       "--trainer.resume", "true", "--trainer.default_root_dir",
                                       root, "--trainer.callbacks", _cli_callback(root, k)],
        fit_launches(k, 2))
    whole = roots["cli_run_whole"]
    run(f"uninterrupted {3 * k}", ["fit", *fit_args, "--trainer.max_steps", str(3 * k),
                                   "--trainer.default_root_dir", whole,
                                   "--trainer.callbacks", _cli_callback(whole, k)],
        fit_launches(3 * k, 4))
    a, b = CheckpointManager(root).load(3 * k), CheckpointManager(whole).load(3 * k)
    differ = state_differences(torch, a, b)
    same_counts = (a["step"], a["opt_state"]["count"]) == (b["step"], b["opt_state"]["count"])
    out["resume_bitwise"] = {"differing_tensors": len(differ), "first": differ[:8],
                             "step_and_count_equal": same_counts}
    print(f"resumed vs uninterrupted at step {3 * k}: {len(differ)} of "
          f"{4 * len(a['params'])} tensors differ {differ[:8]}; step and Adam count equal: "
          f"{same_counts}", flush=True)
    if differ or not same_counts:
        fail(f"the resumed run is not bitwise the uninterrupted one: {differ[:8]}")

    run("sample", ["sample", *ddim_cfg, "--trainer.default_root_dir", root])
    png = os.path.join(root, "samples", f"step_{3 * k:08d}.png")
    run("predict", ["predict", *ddim_cfg, "--trainer.default_root_dir", root,
                    "--trainer.predict_batch", str(BATCH)])
    pred = np.load(os.path.join(root, "predictions", "pred_00000.npy"))
    # generate() on a state that sampled with other weights first (K4 packs
    # them), then had the checkpoint restored into its tensors in place
    config = tcfg.validate_config(tcfg.apply_overrides(tcfg.load_config(ddim_cfg[1]),
                                                       ddim_cfg[2:]))
    lit = tcfg.instantiate(config["model"])
    state = lit.init_state(0, device=dev)
    shape = (BATCH, 32, 32, 3)
    lit.generate(state, step_generator(1337, 0, dev), shape)
    CheckpointManager(root).restore(state)
    want = denorm(lit.generate(state, step_generator(1337, 0, dev), shape)).float().cpu()
    same = pred.tobytes() == want.numpy().tobytes()
    out["predict"] = {"png": os.path.exists(png), "shape": list(pred.shape),
                      "min": float(pred.min()), "max": float(pred.max()), "identical": same}
    print(f"sample: {png} written {out['predict']['png']}; predict: {pred.shape} in "
          f"[{pred.min():.4f}, {pred.max():.4f}], bytes equal to generate() on the restored "
          f"state: {same}", flush=True)
    if not (out["predict"]["png"] and pred.shape == shape and pred.min() >= 0.0
            and pred.max() <= 1.0 and same):
        fail(f"sample/predict from the resumed checkpoint: {out['predict']}")
    # what the loop's cadences cost at full width: one checkpoint, one grid
    timed = os.path.join(root, "timed")
    t0 = time.time()
    CheckpointManager(timed).save(3 * k, state)
    save_s = time.time() - t0
    nbytes = os.path.getsize(os.path.join(timed, str(3 * k), "state.pt"))
    torch.cuda.synchronize()
    t0 = time.time()
    GenerateImage(imgsize=(3, 32, 32), out_dir=timed).generate_and_save(3 * k, lit, state)
    torch.cuda.synchronize()
    out["cadence_cost"] = {"checkpoint_s": save_s, "checkpoint_bytes": nbytes,
                           "grid_s": time.time() - t0}
    print(f"one checkpoint save {save_s:.3f} s ({nbytes / 2**20:.1f} MiB); one GenerateImage "
          f"grid (DDIM-50, n = 8, 10 frames) {out['cadence_cost']['grid_s']:.3f} s [{card}]",
          flush=True)
    del state, lit
    torch.cuda.empty_cache()

    shapes = roots["cli_shapes"]
    rec = run("shapes_demo 20", ["fit", "--config", "configs/ddpm/shapes_demo.yaml",
                                 "--trainer.max_steps", "20", "--trainer.log_every_n_steps",
                                 "10", "--trainer.default_root_dir", shapes, *SHAPES_CUT],
              fit_launches(20, 0))
    logged = _jsonl(os.path.join(shapes, "metrics.jsonl"))
    rec["losses"] = [r["loss"] for r in logged]
    rec["checkpoints"] = CheckpointManager(shapes).steps()
    print(f"shapes_demo (steps_per_call 10): checkpoints {rec['checkpoints']}, losses "
          f"{rec['losses']}", flush=True)
    if rec["checkpoints"] != [20] or len(logged) != 2 or not np.isfinite(rec["losses"]).all():
        fail(f"shapes_demo through the CLI left {rec}")

    # IDDPM: the Shapes recipe and a DPM-Solver++ grid of the CIFAR-10 recipe
    shapes = roots["cli_iddpm_shapes"]
    rec = run("iddpm shapes_demo 20", ["fit", "--config", "configs/iddpm/shapes_demo.yaml",
                                       "--trainer.max_steps", "20", "--trainer.log_every_n_steps",
                                       "10", "--trainer.default_root_dir", shapes, *SHAPES_CUT],
              {k: 20 * v for k, v in PER_TRAIN_STEP_IDDPM.items()})
    logged = _jsonl(os.path.join(shapes, "metrics.jsonl"))
    rec["losses"] = [r["loss"] for r in logged]
    rec["checkpoints"] = CheckpointManager(shapes).steps()
    print(f"iddpm shapes_demo (steps_per_call 10): checkpoints {rec['checkpoints']}, losses "
          f"{rec['losses']}", flush=True)
    if rec["checkpoints"] != [20] or len(logged) != 2 or not np.isfinite(rec["losses"]).all():
        fail(f"iddpm shapes_demo through the CLI left {rec}")
    sample_root = roots["cli_iddpm_sample"]
    rec = run("iddpm cifar10 sample dpm 20", [
        "sample", "--config", "configs/iddpm/cifar10.yaml", "--data.init_args.synthetic", "true",
        "--trainer.sampler", "dpm", "--trainer.sample_steps", "20",
        "--trainer.default_root_dir", sample_root],
        {k: 20 * v for k, v in PER_FORWARD_IDDPM.items()})
    rec["grid"] = os.listdir(os.path.join(sample_root, "samples"))
    print(f"iddpm cifar10 sample --trainer.sampler dpm: {rec['grid']}", flush=True)
    if rec["grid"] != ["step_00000000_dpm20.png"]:
        fail(f"the IDDPM dpm sample wrote {rec['grid']}")
    for root in roots.values():
        shutil.rmtree(root, ignore_errors=True)
    return out


# ------------------------------------------------- EDM, flow and the caches

EDM_NFE = 2 * 18 - 1  # configs/edm/cifar10.yaml: 18-step Heun, no corrector on the last step
FLOW_NFE = 2 * 25  # configs/flow/shapes_demo.yaml: 25 midpoint steps
# the f32 EDM comparison's batch: σ spread from 0.002 (λ ≈ 2.5e5) to 80
EDM_F32_BATCH = 16


def edm_draws(torch, np, n: int, seed: int):
    """Numpy x₀ in [−1, 1], σ geometric from 0.002 to 80, and unit noise."""
    r = np.random.default_rng(seed)
    x0 = torch.tensor(np.clip(r.standard_normal((n, 32, 32, 3)), -1, 1).astype(np.float32))
    sigma = torch.tensor(np.geomspace(0.002, 80.0, n).astype(np.float32))
    noise = torch.tensor(r.standard_normal((n, 32, 32, 3)).astype(np.float32))
    return x0, sigma, noise


def new_site_kernels(torch, np, blocks, k_gn, k_attn, k_res, build, ddpm_models, init_weights,
                     dev, ops, card: str) -> dict:
    """Phase 17: the call sites of K1–K4 that EDM, flow and the caching
    samplers add, on the DDPM UNet (bf16, both switches, random biases and
    affines). At n = 8: EDM's σ-conditioned forward (c_in·x at σ from 0.002
    to 80, the float c_noise), flow's forward (t·1000), and the caching
    samplers' non-key forwards (``cached`` on a key forward's encoder state,
    ``deep`` on its deep-core output at cache_depth 1), each held to its
    launches (1/6/22, 1/6/22, 1/4/14, 1/0/5) and every K1/K3/K4 call of it
    against its plain version (``TOL``), timed; then K1, K2, K3 and the
    attention backward at every call site of one ``LitEDM`` and one
    ``LitFlow`` training step at batch 128 (:func:`train_kernels`)."""
    from dmme_tpu_torch import equations as eq
    from dmme_tpu_torch.training import LitEDM, LitFlow

    m = ddpm_models.UNet(dtype=torch.bfloat16, fused_norm=True, fused_block=True)
    init_weights(m, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, m, torch.Generator().manual_seed(SEED + 1))
    m = m.to(dev).eval()
    x0, sigma, noise = edm_draws(torch, np, BATCH, SEED + 70)
    c = eq.edm.precond(sigma)
    x_edm = c.c_in[:, None, None, None] * (x0 + sigma[:, None, None, None] * noise)
    t_flow = torch.rand((BATCH,), generator=torch.Generator().manual_seed(SEED + 71))
    x_flow = eq.flow.interpolate(x0, noise, t_flow)
    g = torch.Generator().manual_seed(SEED + 72)
    x_key, x_step = (torch.randn((BATCH, 32, 32, 3), generator=g) for _ in range(2))
    t_key, t_step = torch.tensor([801] * BATCH), torch.tensor([768] * BATCH)
    with torch.no_grad():
        _, feats = m(x_key.to(dev), t_key.to(dev), return_features=True)
        _, deep = m(x_key.to(dev), t_key.to(dev), cache_depth=1, return_deep=True)
    kinds = {"edm": (x_edm, c.c_noise, {}, PER_FORWARD),
             "flow": (x_flow, t_flow * 1000.0, {}, PER_FORWARD),
             "cached": (x_step, t_step, {"cached": feats}, PER_FORWARD_CACHED),
             "deep": (x_step, t_step, {"cache_depth": 1, "deep_cache": deep}, PER_FORWARD_DEEP)}
    out = {}
    for name, (xs, ts, kw, want) in kinds.items():
        reset_counts(ops)
        with torch.no_grad():
            m(xs.to(dev), ts.to(dev), **kw)
        torch.cuda.synchronize()
        launches = counts(ops)
        expect_bf16_only(f"{name} forward")
        print(f"{name} forward at n = {BATCH}: launches {launches} (expected {want})", flush=True)
        if launches != want:
            fail(f"the {name} forward launched {launches}, expected {want}")
        recorded, _ = record_forwards(torch, blocks, {name: (m, xs, ts, want, kw)}, dev)
        rows, failures = forward_rows(torch, k_gn, k_attn, k_res, build, dev, recorded)
        if failures:
            fail(f"{name} forward kernels disagree with their plain versions: {failures}")
        flat = [dict(r, sites=r["sites"][name]) for r in rows]
        per = {k: per_site_sum(flat, k) for k in ("group_norm_silu", "attention", "resblock")
               if want[k]}
        for k, v in per.items():
            print(f"per {name} forward at n = {BATCH}, {k}: " + ", ".join(
                f"{f} {x:.4f}" for f, x in v.items() if isinstance(x, float)) + f" [{card}]",
                flush=True)
        out[name] = {"launches": launches, "rows": rows, "per_forward": per}
    del m, feats, deep
    torch.cuda.empty_cache()
    for name, lit_cls in (("edm_train", LitEDM), ("flow_train", LitFlow)):
        print(f"-- {lit_cls.__name__}(dtype='bf16') training step at batch {TRAIN_BATCH}",
              flush=True)
        out[name] = train_kernels(torch, blocks, k_gn, k_attn, None, init_weights, lit_cls, dev,
                                  card, ops)
        torch.cuda.empty_cache()
    return out


EDM_ROOT = os.path.join("build", "cli_edm")
FLOW_ROOT = os.path.join("build", "cli_flow")


def continuous_fit(torch, np, ops, dev, card: str, family: str) -> dict:
    """Phases 19 and 21: ``trainer.main fit`` for ``FIT_STEPS`` steps of
    ``configs/edm/cifar10.yaml`` (synthetic CIFAR-10, GenerateImage every 10
    steps: 18-step Heun grids at steps 10 and 20 and at the end) or of
    ``configs/flow/shapes_demo.yaml`` (Shapes, 10 steps a call), full width,
    batch 128, bf16: launches 45/45/6/0 a step and 1/6/22 a sampling forward,
    the checkpoint, grids and JSONL (step ms from its ``imgs_per_sec``); then
    ``TIMED_STEPS`` steps of the same train step from the saved state, on
    synthetic CIFAR-10 batches, timed with CUDA events, and the device's idle
    share under the profiler (:func:`timed_steps`)."""
    import shutil

    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.parallel import make_train_step
    from dmme_tpu_torch.training import CheckpointManager

    root = EDM_ROOT if family == "edm" else FLOW_ROOT
    shutil.rmtree(root, ignore_errors=True)
    if family == "edm":
        cfg = ["--config", "configs/edm/cifar10.yaml", "--data.init_args.synthetic", "true"]
        extra = ["--trainer.log_every_n_steps", "1", "--trainer.callbacks", _cli_callback(root)]
        grid_forwards = 3 * EDM_NFE
    else:
        cfg = ["--config", "configs/flow/shapes_demo.yaml"]
        extra = ["--trainer.log_every_n_steps", "10"]
        grid_forwards = 0
    want = {k: v * FIT_STEPS + PER_FORWARD[k] * grid_forwards for k, v in PER_TRAIN_STEP.items()}
    rec = cli_run(torch, ops, card, f"{family} fit {FIT_STEPS}",
                  ["fit", *cfg, "--trainer.max_steps", str(FIT_STEPS),
                   "--trainer.default_root_dir", root, *extra], want)
    logged = _jsonl(os.path.join(root, "metrics.jsonl"))
    rec["losses"] = [r["loss"] for r in logged]
    rec["step_ms_from_jsonl"] = [1e3 * TRAIN_BATCH / r["imgs_per_sec"] for r in logged]
    rec["checkpoints"] = CheckpointManager(root).steps()
    rec["grids"] = (sorted(os.listdir(os.path.join(root, "samples"))) if family == "edm"
                    else [])
    print(f"{family} fit: checkpoints {rec['checkpoints']}, grids {rec['grids']}, losses "
          f"{[round(v, 4) for v in rec['losses']]}; step ms from the JSONL "
          f"{[round(v, 2) for v in rec['step_ms_from_jsonl']]} (median "
          f"{statistics.median(rec['step_ms_from_jsonl']):.2f}) [{card}]", flush=True)
    want_grids = ["step_00000010.png", "step_00000020.png"] if family == "edm" else []
    if (rec["checkpoints"] != [FIT_STEPS] or rec["grids"] != want_grids
            or len(logged) != (FIT_STEPS if family == "edm" else 2)
            or not np.isfinite(rec["losses"]).all()):
        fail(f"{family} fit through the CLI left {rec}")

    config = tcfg.validate_config(tcfg.apply_overrides(tcfg.load_config(cfg[1]), cfg[2:]))
    lit = tcfg.instantiate(config["model"])
    state = CheckpointManager(root).restore(lit.init_state(0, device=dev))
    dm = CIFAR10(synthetic=True, batch_size=TRAIN_BATCH)
    dm.setup("fit")
    it = dm.train_iter(SEED + 9)

    def batch():
        return torch.from_numpy(next(it)).pin_memory().to(dev, non_blocking=True)

    step = make_train_step(lit.make_loss_fn(dm))
    state, _ = step(state, batch(), SEED)  # first launches of this step object
    state, rec["timing"], rec["profile_3_steps"], rec["profile_1_step"] = timed_steps(
        torch, np, step, state, batch, card)
    del state, lit
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


def continuous_serve(torch, np, blocks, dev, ops, card: str, family: str) -> dict:
    """Phases 20 and 21: ``LitEDM(dtype="bf16")`` (the harness of
    configs/edm/cifar10.yaml) or ``LitFlow(dtype="bf16")`` behind
    ``make_server``, random weights with random biases and affines. EDM:
    ``default`` (18-step Heun, 35 evaluations) at n = 1, 8 and 16 and a repeat
    of 8 with identical bytes, and ``edm`` at 10 steps (19 evaluations) at
    n = 8; flow: ``default`` (25 midpoint steps, 50 evaluations) and ``flow``
    at 10 steps at n = 8, each repeated. Launches 1/6/22 a forward; the other
    family's name and the discrete-schedule samplers answered 400; one n = 8
    ``default`` request under the profiler."""
    from dmme_tpu_torch.serving import SAMPLERS, Sampler
    from dmme_tpu_torch.training import LitEDM, LitFlow, TrainState

    lit = (LitEDM if family == "edm" else LitFlow)(dtype="bf16")
    lit.init_state(SEED)
    randomize_affines(torch, blocks, lit.model, torch.Generator().manual_seed(SEED + 1))
    state = TrainState.create({k: v.detach().clone() for k, v in lit.model.state_dict().items()},
                              lit.make_optimizer())
    sampler = Sampler(lit, state, img_size=32, device=dev)
    url, stop = _serve(torch, sampler)
    model = "EDM" if family == "edm" else "flow"
    out = {}
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health.get("samplers") != list(SAMPLERS):
            fail(f"healthz: {health}")
        if family == "edm":
            out["requests"], launches = default_requests(np, url, ops, model, card)
            want = launches_for(PER_FORWARD, 4 * EDM_NFE)
            print(f"EDM: launches during the four default requests {launches} (expected {want})",
                  flush=True)
            if launches != want:
                fail(f"EDM serve launched {launches}, expected {want}")
            out["launches"] = launches
            out["override"] = solver_requests(np, url, ops, model, card, [
                ("edm", 10, launches_for(PER_FORWARD, 2 * 10 - 1))])
        else:
            out["requests"] = solver_requests(np, url, ops, model, card, [
                ("default", None, launches_for(PER_FORWARD, FLOW_NFE)),
                ("flow", 10, launches_for(PER_FORWARD, 2 * 10))])
            out["launches"] = out["requests"][0]["launches"]
        other = "flow" if family == "edm" else "edm"
        needle = "flow-matching-trained" if family == "edm" else "EDM-trained"
        out["rejected"] = {other: rejected(url, model, other, needle),
                           "ddim": rejected(url, model, "ddim", "discrete-schedule"),
                           "cached": rejected(url, model, "cached", "discrete-schedule")}
    finally:
        stop()
    prof = profile_fn(torch, lambda: sampler.sample(BATCH, seed=5))
    out["profile_n8"] = prof
    print(f"{model} default n=8 under torch.profiler: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['busy_ms']:.2f} ms, idle share {prof['idle_share']:.3f} [{card}]", flush=True)
    for name, ms, count in prof["top"]:
        print(f"    {ms:9.3f} ms {count:6d}x  {name}", flush=True)
    return out


def f32_edm_phase(torch, np, blocks, ddpm_models, init_weights, dev, ops, card: str) -> dict:
    """Phase 22: ``LitEDM()`` (f32, the harness's default dtype) takes one
    full-width training step at batch 128 on the card (K1/K2/K3 45/45/6:
    K1 and K2 of ``group_norm.cu``, K3 in f32 on the tensor cores; no bf16
    kernel). Then, dropout off, on the same weights: ``loss_given`` and its
    gradient at batch 16 with σ from 0.002 to 80, and the Heun step from the
    middle of the 18-step grid at n = 8 (two forwards, K1/K3/K4 2/12/44
    launches), against f32 on the CPU
    within ``F32_REL_L2``; the bf16 harness on the same inputs is the
    control that must miss it, in the gradient and in the step."""
    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.parallel import make_train_step
    from dmme_tpu_torch.training import LitEDM

    none = {k: 0 for k in ops}
    w_model = ddpm_models.UNet(dtype=torch.float32)
    init_weights(w_model, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, w_model, torch.Generator().manual_seed(SEED + 1))
    weights = {k: v.detach().clone() for k, v in w_model.state_dict().items()}
    dm = CIFAR10(synthetic=True, synthetic_size=2 * TRAIN_BATCH, batch_size=TRAIN_BATCH)
    dm.setup("fit")
    batch = torch.from_numpy(next(dm.train_iter(SEED))).to(dev)

    lit = LitEDM()
    state = lit.init_state(SEED, device=dev)
    with torch.no_grad():
        for k, v in state.params.items():
            v.copy_(weights[k])
    reset_counts(ops)
    _, metrics = make_train_step(lit.make_loss_fn(dm))(state, batch, SEED)
    torch.cuda.synchronize()
    out = {"train": {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                     "launches": counts(ops), "wide": wide_counts()}}
    print(f"LitEDM() one training step at batch {TRAIN_BATCH} (f32): loss "
          f"{out['train']['loss']:.6f} grad_norm {out['train']['grad_norm']:.4f}; bf16 kernel "
          f"launches {out['train']['launches']}; f32/fp16 launches {out['train']['wide']}",
          flush=True)
    if not (np.isfinite(out["train"]["loss"]) and np.isfinite(out["train"]["grad_norm"])):
        fail("the f32 EDM training step is not finite")
    want_step = wide_expected("f32", PER_TRAIN_STEP)
    if out["train"]["launches"] != none or out["train"]["wide"] != want_step:
        fail(f"the f32 EDM step launched {out['train']}, expected none and {want_step}")
    del state

    x0, sigma, noise = edm_draws(torch, np, EDM_F32_BATCH, SEED + 90)
    algo = lit.diffusion_model
    # a mid-grid Heun step, where the network's output moves the state most
    # (from σ_max the state's own scale, 80, hides bf16's error in the step)
    i_heun = algo.steps // 2
    x_i = x0[:BATCH] + algo.sigmas[i_heun] * noise[:BATCH]

    def harness(dtype):
        h = LitEDM(dtype=dtype)
        for mod in h.model.modules():
            if isinstance(mod, blocks.ResBlock):
                mod.dropout = 0.0
        return h

    def measure(h, device):
        params = {k: v.to(device).requires_grad_(True) for k, v in weights.items()}
        loss = algo.loss_given(h.model_fn, params, x0.to(device), sigma.to(device),
                               noise.to(device), train=True)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            p = {k: v.detach() for k, v in params.items()}
            torch.cuda.synchronize()
            reset_counts(ops)
            step = algo.sampling_step(h.model_fn, p, x_i.to(device), i_heun)
            torch.cuda.synchronize()
            out["heun_launches"] = {"bf16": counts(ops), "wide": wide_counts()}
        return {"loss": loss.detach().cpu(),
                "grad": torch.cat([g.detach().float().flatten().cpu() for g in grads]),
                "step": step.float().cpu()}

    def readings(got, ref) -> dict:
        return {"loss_rel_err": float(abs(got["loss"] - ref["loss"]) / abs(ref["loss"])),
                "grad_rel_l2": rel_l2(got["grad"], ref["grad"]),
                "step_rel_l2": rel_l2(got["step"], ref["step"])}

    card_h = harness("f32")
    card_h.model.to(dev)
    got = measure(card_h, dev)
    if not all(bool(v.isfinite().all()) for v in got.values()):
        fail("the f32 EDM loss, gradient or Heun step on the card is not finite")
    heun = out.pop("heun_launches")
    want_heun = wide_expected("f32", launches_for(PER_FORWARD, 2))
    print(f"f32 Heun step at n = {BATCH}: bf16 launches {heun['bf16']}, f32/fp16 launches "
          f"{heun['wide']} (expected {want_heun})", flush=True)
    if heun["bf16"] != none or heun["wide"] != want_heun:
        fail(f"the f32 Heun step launched {heun}, expected none and {want_heun}")
    ref = measure(harness("f32"), torch.device("cpu"))
    control = harness("bf16")
    control.model.to(dev)
    out["vs_cpu"] = readings(got, ref)
    out["bf16_control"] = readings(measure(control, dev), ref)
    out["heun_launches"] = heun
    print(f"f32 EDM card vs f32 CPU (σ {float(sigma[0]):.3g}…{float(sigma[-1]):.3g}, batch "
          f"{EDM_F32_BATCH}; Heun step {i_heun} from σ {float(algo.sigmas[i_heun]):.4g}): "
          + ", ".join(
              f"{k} {v:.3e}" for k, v in out["vs_cpu"].items()) + f" (<= {F32_REL_L2}); bf16 "
          "control: " + ", ".join(f"{k} {v:.3e}" for k, v in out["bf16_control"].items()),
          flush=True)
    if not all(v <= F32_REL_L2 for v in out["vs_cpu"].values()):
        fail("the f32 EDM harness on the card disagrees with the f32 CPU reference")
    if not (out["bf16_control"]["grad_rel_l2"] > F32_REL_L2
            and out["bf16_control"]["step_rel_l2"] > F32_REL_L2):
        fail("the f32 EDM comparison does not tell bf16 compute from f32")
    return out


# the class-conditional demo (classifier-free guidance) and the upsampler demo
CFG_CONFIG = "configs/ddpm/shapes_cfg_demo.yaml"
SR_CONFIG = "configs/ddpm/shapes_sr_demo.yaml"
CFG_CLASSES, CFG_SCALE = 2, 2.0  # shapes_cfg_demo.yaml: num_classes, guidance_scale
# the DDPM UNet's parameters and the class table's 2 + 1 rows of 512
CFG_PARAMS = 32_416_643 + (CFG_CLASSES + 1) * 512
# the upsampler's UNet as the config gives it, in bf16 with both kernel switches on
SR_KERNELS = ["--model.init_args.model.init_args.dtype", "bf16",
              "--model.init_args.model.init_args.fused_norm", "true",
              "--model.init_args.model.init_args.fused_block", "true"]
SR_BATCH = 32  # shapes_sr_demo.yaml's batch size
#: the CFG fit's steps a call and its checkpoint cadence (the config's 10
#: steps a call, cut: a chunk of 5 holds the same checks)
CFG_CADENCE = 5


def eval_launches(blocks, model) -> dict:
    """K1/K2/K3/K4 launches of one eval forward (both switches on): the
    output norm, the attention sites, the ResBlocks."""
    return {"group_norm_silu": 1, "group_norm_silu_bwd": 0,
            "attention": sum(isinstance(m, blocks.SelfAttention2d) for m in model.modules()),
            "resblock": sum(isinstance(m, blocks.ResBlock) for m in model.modules())}


def train_launches(blocks, model) -> dict:
    """K1/K2/K3/K4 launches of one training step."""
    n_res = sum(isinstance(m, blocks.ResBlock) for m in model.modules())
    return {"group_norm_silu": 2 * n_res + 1, "group_norm_silu_bwd": 2 * n_res + 1,
            "attention": sum(isinstance(m, blocks.SelfAttention2d) for m in model.modules()),
            "resblock": 0}


def sr_harness(torch, argv=()):
    """The harness of configs/ddpm/shapes_sr_demo.yaml with ``SR_KERNELS``
    and ``argv`` applied."""
    from dmme_tpu_torch import config as tcfg

    over = SR_KERNELS + list(argv)
    return tcfg.instantiate(tcfg.validate_config(
        tcfg.apply_overrides(tcfg.load_config(SR_CONFIG), over))["model"])


def _per_forward(rows, name: str, card: str, label: str,
                 kinds=("group_norm_silu", "attention", "resblock")) -> dict:
    """Per-site sums of ``kinds`` (K1/K3/K4) over the call sites of forward ``name``."""
    flat = [dict(r, sites=r["sites"][name]) for r in rows if name in r["sites"]]
    per = {k: per_site_sum(flat, k) for k in kinds}
    for k, v in per.items():
        print(f"per {label}, {k}: " + ", ".join(
            f"{f} {x:.4f}" for f, x in v.items() if isinstance(x, float)) + f" [{card}]",
            flush=True)
    return per


def cfg_kernels(torch, np, blocks, k_gn, k_attn, k_res, build, ddpm_models, init_weights,
                dev, ops, card: str) -> dict:
    """Phase 24: the call sites classifier-free guidance gives K1–K4 on the
    DDPM UNet with a class table (bf16, both switches, random biases,
    affines and class rows). A guided forward of n requests is one UNet call
    at N = 2n (labels ‖ the null token): at n = 1, 8, 16 its launches must be
    1/6/22 and every K1/K3/K4 call of it at N = 2, 16, 32 is held against its
    plain version (``TOL``) and timed; then K1, K2, K3 and the attention
    backward at every call site of one ``LitDDPM(num_classes=2)`` training
    step at batch 128 on labelled images (:func:`train_kernels`)."""
    from dmme_tpu_torch.diffusion import classifier_free
    from dmme_tpu_torch.training import LitDDPM

    m = ddpm_models.UNet(dtype=torch.bfloat16, fused_norm=True, fused_block=True,
                         num_classes=CFG_CLASSES)
    init_weights(m, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, m, torch.Generator().manual_seed(SEED + 1))
    m = m.to(dev).eval()
    runs, out = {}, {"launches": {}}
    for n in SERVE_BATCHES:
        g = torch.Generator().manual_seed(SEED + 100 + n)
        x = torch.randn((n, 32, 32, 3), generator=g).to(dev)
        t = torch.randint(1, 1000, (n,), generator=g).to(dev)
        y = torch.randint(0, CFG_CLASSES, (n,), generator=g).to(dev)
        calls = []

        def fn(params, xx, tt, _calls=calls, **kw):
            _calls.append(xx.shape[0])
            return m(xx, tt, **kw)

        guided = classifier_free(fn, y, CFG_SCALE, CFG_CLASSES)
        reset_counts(ops)
        with torch.no_grad():
            guided(None, x, t)
        torch.cuda.synchronize()
        launches = counts(ops)
        expect_bf16_only(f"guided forward at n = {n}")
        print(f"guided forward at n = {n}: UNet calls at N = {calls}, launches {launches} "
              f"(expected {PER_FORWARD})", flush=True)
        if calls != [2 * n] or launches != PER_FORWARD:
            fail(f"the guided forward at n = {n} made calls {calls} with launches {launches}")
        out["launches"][n] = launches
        # the call the wrapper makes: x ‖ x, t ‖ t, y ‖ null
        null = torch.full_like(y, CFG_CLASSES)
        runs[f"cfg_N{2 * n}"] = (m, torch.cat([x, x]), torch.cat([t, t]), PER_FORWARD,
                                 {"y": torch.cat([y, null])})
    recorded, _ = record_forwards(torch, blocks, runs, dev)
    rows, failures = forward_rows(torch, k_gn, k_attn, k_res, build, dev, recorded)
    if failures:
        fail(f"guided forward kernels disagree with their plain versions: {failures}")
    out["rows"] = rows
    out["per_forward"] = {name: _per_forward(rows, name, card, f"guided call, {name}")
                          for name in runs}
    del m, recorded
    torch.cuda.empty_cache()
    print(f"-- LitDDPM(dtype='bf16', num_classes={CFG_CLASSES}) training step at batch "
          f"{TRAIN_BATCH}, labelled", flush=True)
    out["train"] = train_kernels(torch, blocks, k_gn, k_attn, None, init_weights, None, dev,
                                 card, ops, lit=LitDDPM(dtype="bf16", num_classes=CFG_CLASSES),
                                 labels=CFG_CLASSES)
    torch.cuda.empty_cache()
    return out


def sr_kernels(torch, np, blocks, k_gn, k_attn, k_res, build, init_weights, dev, ops,
               card: str) -> dict:
    """Phase 28 (kernels): the upsampler's UNet at the widths of
    configs/ddpm/shapes_sr_demo.yaml (channels 32/64/64, 8 groups, C/G = 4,
    attention at depth 3, input x_t ‖ cond of 6 channels), bf16 with both
    switches: K1, K3 and K4 at every call site of an eval forward at n = 8
    (launches 1/4/11) and K1, K2, K3 and the attention backward at every call
    site of one training step at batch 32 (23/23/4/0), each held against its
    plain version and timed."""
    lit = sr_harness(torch)
    m = lit.model
    init_weights(m, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, m, torch.Generator().manual_seed(SEED + 1))
    m = m.to(dev).eval()
    want = eval_launches(blocks, m)
    g = torch.Generator().manual_seed(SEED + 120)
    x = torch.randn((BATCH, 32, 32, 2 * 3), generator=g)
    t = torch.randint(1, 200, (BATCH,), generator=g)
    reset_counts(ops)
    with torch.no_grad():
        m(x.to(dev), t.to(dev))
    torch.cuda.synchronize()
    launches = counts(ops)
    expect_bf16_only("upsampler forward")
    print(f"upsampler forward at n = {BATCH}: launches {launches} (expected {want})", flush=True)
    if launches != want:
        fail(f"the upsampler forward launched {launches}, expected {want}")
    recorded, _ = record_forwards(torch, blocks, {"sr": (m, x, t, want)}, dev)
    rows, failures = forward_rows(torch, k_gn, k_attn, k_res, build, dev, recorded)
    if failures:
        fail(f"upsampler forward kernels disagree with their plain versions: {failures}")
    out = {"launches": launches, "rows": rows,
           "per_forward": _per_forward(rows, "sr", card, f"upsampler forward at n = {BATCH}")}
    del m, recorded
    torch.cuda.empty_cache()
    print(f"-- the upsampler's training step at batch {SR_BATCH}", flush=True)
    out["train"] = train_kernels(torch, blocks, k_gn, k_attn, None, init_weights, None, dev,
                                 card, ops, lit=sr_harness(torch), batch_size=SR_BATCH)
    torch.cuda.empty_cache()
    return out


def cfg_fit(torch, np, blocks, ops, dev, card: str) -> dict:
    """Phase 25: ``trainer.main`` on configs/ddpm/shapes_cfg_demo.yaml
    (the full-width DDPM UNet with a 2-class table, bf16, batch 128, labelled
    Shapes, ``CFG_CADENCE`` (5) steps a call, not the config's 10): the
    model's parameter count; fit 10 steps with checkpoints at 5 and 10
    (launches 45/45/6/0 a step); a resume to 15 against an uninterrupted
    15-step run, bit for bit (the drop masks come
    from the step's generator, restored with the step); ``validate`` on the
    true labels (two eval forwards, 1/6/22 each); ``sample --trainer.sampler
    ddim`` (DDIM-50 at n = 8: one guided call at N = 16 a step); then the
    saved state's labelled train step timed (median step ms) and profiled
    (idle share) under the library's default cuDNN settings."""
    import shutil

    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.data import Shapes
    from dmme_tpu_torch.parallel import make_train_step
    from dmme_tpu_torch.training import CheckpointManager

    torch.backends.cudnn.deterministic = True
    roots = {k: os.path.join("build", k) for k in ("cli_cfg", "cli_cfg_whole")}
    for root in roots.values():
        shutil.rmtree(root, ignore_errors=True)
    k = CFG_CADENCE  # the steps a call: the cadences snap to its chunks
    cfg = ["--config", CFG_CONFIG, "--trainer.tensorboard", "false", *SHAPES_CUT,
           "--trainer.steps_per_call", str(k)]
    fit_args = cfg + ["--trainer.ckpt_every_n_steps", str(k), "--trainer.log_every_n_steps",
                      str(k)]
    lit = tcfg.instantiate(tcfg.validate_config(tcfg.load_config(CFG_CONFIG))["model"])
    n_params = sum(p.numel() for p in lit.model.parameters())
    print(f"{CFG_CONFIG}: {type(lit).__name__}(num_classes={lit.num_classes}, cond_dropout="
          f"{lit.cond_dropout}, guidance_scale={lit.guidance_scale}), dtype {lit.model.dtype}, "
          f"{n_params:,} parameters (expected {CFG_PARAMS:,})", flush=True)
    if n_params != CFG_PARAMS or lit.model.class_embed.weight.shape != (CFG_CLASSES + 1, 512):
        fail(f"the CFG demo's model has {n_params} parameters")
    per_step = train_launches(blocks, lit.model)
    del lit
    out = {"params": n_params}

    def steps(n):
        return {k: v * n for k, v in per_step.items()}

    root = roots["cli_cfg"]
    out["fit"] = cli_run(torch, ops, card, f"cfg fit {2 * k}",
                         ["fit", *fit_args, "--trainer.max_steps", str(2 * k),
                          "--trainer.default_root_dir", root], steps(2 * k))
    logged = _jsonl(os.path.join(root, "metrics.jsonl"))
    out["fit"]["losses"] = [r["loss"] for r in logged]
    out["fit"]["step_ms_from_jsonl"] = [1e3 * TRAIN_BATCH / r["imgs_per_sec"] for r in logged]
    out["fit"]["checkpoints"] = CheckpointManager(root).steps()
    print(f"cfg fit: checkpoints {out['fit']['checkpoints']}, losses "
          f"{[round(v, 5) for v in out['fit']['losses']]}, step ms from the JSONL "
          f"{[round(v, 2) for v in out['fit']['step_ms_from_jsonl']]} [{card}]", flush=True)
    if (out["fit"]["checkpoints"] != [k, 2 * k] or len(logged) != 2
            or not np.isfinite(out["fit"]["losses"]).all()):
        fail(f"the CFG fit through the CLI left {out['fit']}")
    out["resume"] = cli_run(torch, ops, card, f"cfg resume {2 * k} -> {3 * k}",
                            ["fit", *fit_args, "--trainer.max_steps", str(3 * k),
                             "--trainer.resume", "true", "--trainer.default_root_dir", root],
                            steps(k))
    whole = roots["cli_cfg_whole"]
    out["whole"] = cli_run(torch, ops, card, f"cfg uninterrupted {3 * k}",
                           ["fit", *fit_args, "--trainer.max_steps", str(3 * k),
                            "--trainer.default_root_dir", whole], steps(3 * k))
    a, b = CheckpointManager(root).load(3 * k), CheckpointManager(whole).load(3 * k)
    differ = state_differences(torch, a, b)
    out["resume_bitwise"] = {"differing_tensors": len(differ), "first": differ[:8]}
    print(f"cfg resumed vs uninterrupted at step {3 * k}: {len(differ)} of {4 * len(a['params'])} "
          f"tensors differ {differ[:8]}", flush=True)
    if differ or a["step"] != b["step"]:
        fail(f"the resumed CFG run is not bitwise the uninterrupted one: {differ[:8]}")
    out["validate"] = cli_run(torch, ops, card, "cfg validate",
                              ["validate", *cfg, "--trainer.default_root_dir", root,
                               "--trainer.limit_val_batches", "2"],
                              launches_for(PER_FORWARD, 2))
    out["sample"] = cli_run(torch, ops, card, "cfg sample --trainer.sampler ddim",
                            ["sample", *cfg, "--trainer.default_root_dir", root,
                             "--trainer.sampler", "ddim"], launches_for(PER_FORWARD, 50))
    png = os.path.join(root, "samples", f"step_{3 * k:08d}_ddim50.png")
    out["sample"]["png"] = os.path.exists(png)
    if not out["sample"]["png"]:
        fail(f"cfg sample wrote no {png}")

    torch.backends.cudnn.deterministic = False
    lit = tcfg.instantiate(tcfg.validate_config(tcfg.load_config(CFG_CONFIG))["model"])
    state = CheckpointManager(root).restore(lit.init_state(0, device=dev))
    dm = Shapes(size=4 * TRAIN_BATCH, batch_size=TRAIN_BATCH, with_labels=True)
    dm.setup("fit")
    it = dm.train_iter(SEED + 9)

    def batch():
        images, labels = next(it)
        return (torch.from_numpy(images).pin_memory().to(dev, non_blocking=True),
                torch.from_numpy(labels).to(dev))

    step = make_train_step(lit.make_loss_fn(dm))
    state, _ = step(state, batch(), SEED)  # first launches of this step object
    state, out["timing"], out["profile_3_steps"], out["profile_1_step"] = timed_steps(
        torch, np, step, state, batch, card)
    del state, lit
    for root in roots.values():
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def cfg_serve(torch, np, blocks, dev, ops, card: str) -> dict:
    """Phase 26: ``LitDDIM(dtype="bf16", num_classes=2, guidance_scale=2)``
    behind ``make_server`` (random weights, biases, affines and class rows):
    ``default`` (DDIM-50) requests at n = 8 (repeated for identical bytes),
    1 and 16, each one guided call at N = 2n a step (launches 50 × 1/6/22);
    ``dpm`` and ``unipc`` at n = 8; ``cached``, ``deep`` and ``deep_dpm``
    answered 400 with JAX's message; one n = 8 request under the profiler."""
    from dmme_tpu_torch.serving import Sampler
    from dmme_tpu_torch.training import LitDDIM, TrainState

    lit = LitDDIM(dtype="bf16", timesteps=1000, sample_steps=50, tau_schedule="quadratic",
                  num_classes=CFG_CLASSES, guidance_scale=CFG_SCALE)
    lit.init_state(SEED)
    randomize_affines(torch, blocks, lit.model, torch.Generator().manual_seed(SEED + 1))
    state = TrainState.create({k: v.detach().clone() for k, v in lit.model.state_dict().items()},
                              lit.make_optimizer())
    sampler = Sampler(lit, state, img_size=32, device=dev)
    url, stop = _serve(torch, sampler)
    out = {}
    try:
        _post(url, {"n": 1, "seed": 99, "format": "npy"})  # warm
        out["requests"] = solver_requests(np, url, ops, "CFG", card, [
            ("default", None, launches_for(PER_FORWARD, 50))])
        out["launches_by_n"] = {BATCH: out["requests"][0]["launches"]}
        for n in (1, 16):
            reset_counts(ops)
            code, data, secs = _post(url, {"n": n, "seed": 3, "format": "npy"})
            launches = counts(ops)
            imgs = np.load(io.BytesIO(data)) if code == 200 else None
            ok = bool(code == 200 and imgs.shape == (n, 32, 32, 3) and np.isfinite(imgs).all())
            print(f"CFG: POST /sample n={n}: {secs:.3f} s, launches {launches} [{card}]"
                  + ("" if ok else "  FAIL"), flush=True)
            if not ok or launches != launches_for(PER_FORWARD, 50):
                fail(f"CFG n = {n}: {code}, launches {launches}")
            expect_bf16_only(f"CFG n = {n} request")
            out["requests"].append({"n": n, "s": secs, "launches": launches})
            out["launches_by_n"][n] = launches
        out["solvers"] = solver_requests(np, url, ops, "CFG", card, [
            (name, steps, launches_for(PER_FORWARD, steps)) for name, steps in SOLVERS
            if name != "ddim"])
        out["rejected"] = {name: rejected(url, "CFG", name, "does not support class-conditional")
                           for name, _, _ in CACHING}
    finally:
        stop()
    prof = profile_fn(torch, lambda: sampler.sample(BATCH, seed=5))
    out["profile_n8"] = prof
    print(f"CFG default n=8 under torch.profiler: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['busy_ms']:.2f} ms, idle share {prof['idle_share']:.3f} [{card}]", flush=True)
    for name, ms, count in prof["top"]:
        print(f"    {ms:9.3f} ms {count:6d}x  {name}", flush=True)
    return out


def cfg_iddpm(torch, np, blocks, dev, ops, card: str) -> dict:
    """Phase 27: guided IDDPM, the ε ‖ v split on the card:
    ``LitIDDPM(num_classes=10, sample_steps=50, dtype="bf16")`` (the IDDPM
    UNet with a 10-class table) trains 3 steps on labelled synthetic
    CIFAR-10 at batch 128 (launches 45/45/11/0 a step), then answers one
    n = 8 request over HTTP (50 guided calls at N = 16, launches 1/11/22
    each), repeated for identical bytes."""
    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.serving import Sampler
    from dmme_tpu_torch.training import LitIDDPM, fit

    lit = LitIDDPM(num_classes=10, sample_steps=50, dtype="bf16")
    dm = CIFAR10(synthetic=True, synthetic_size=4 * TRAIN_BATCH, batch_size=TRAIN_BATCH,
                 with_labels=True)
    reset_counts(ops)
    state = fit(lit, dm, max_steps=3, log_every=1, device=dev)
    torch.cuda.synchronize()
    launches = counts(ops)
    expect_bf16_only("guided IDDPM fit")
    want = {k: 3 * v for k, v in PER_TRAIN_STEP_IDDPM.items()}
    print(f"guided IDDPM fit 3 steps: launches {launches} (expected {want})", flush=True)
    if launches != want:
        fail(f"the guided IDDPM fit launched {launches}, expected {want}")
    sampler = Sampler(lit, state, img_size=32, device=dev)
    url, stop = _serve(torch, sampler)
    try:
        _post(url, {"n": 1, "seed": 99, "format": "npy"})  # warm
        req = solver_requests(np, url, ops, "guided IDDPM", card, [
            ("default", None, launches_for(PER_FORWARD_IDDPM, 50))])
    finally:
        stop()
    return {"fit_launches": launches, "request": req}


def sr_fit(torch, np, blocks, ops, dev, card: str) -> dict:
    """Phase 28: ``trainer.main fit`` of configs/ddpm/shapes_sr_demo.yaml
    (factor 2, T = 200, batch 32, Shapes; the UNet in bf16 with both kernel
    switches, ``SR_KERNELS``) for 20 steps (launches 23/23/4/0 a step); then,
    from the saved state, ``generate(low_res=)`` at n = 8 from 16×16 images
    (200 ancestral steps at 32×32, launches 1/4/11 each), repeated for
    identical bytes; ``serve`` refused."""
    import shutil

    from dmme_tpu_torch import serving
    from dmme_tpu_torch.training import CheckpointManager

    root = os.path.join("build", "cli_sr")
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--config", SR_CONFIG, *SR_KERNELS, "--trainer.log_every_n_steps", "10",
            "--trainer.default_root_dir", root]
    lit = sr_harness(torch)
    per_step, per_fwd = train_launches(blocks, lit.model), eval_launches(blocks, lit.model)
    out = {"fit": cli_run(torch, ops, card, f"sr fit {FIT_STEPS}",
                          ["fit", *argv, "--trainer.max_steps", str(FIT_STEPS)],
                          {k: v * FIT_STEPS for k, v in per_step.items()})}
    state = CheckpointManager(root).restore(lit.init_state(0, device=dev))
    g = torch.Generator().manual_seed(SEED + 130)
    low = (torch.rand((BATCH, 16, 16, 3), generator=g) * 2 - 1).to(dev)
    reset_counts(ops)
    t0 = time.time()
    hi = lit.generate(state, torch.Generator(device=dev).manual_seed(1), low_res=low)
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = counts(ops)
    again = lit.generate(state, torch.Generator(device=dev).manual_seed(1), low_res=low)
    steps = lit.diffusion_model.timesteps
    want = launches_for(per_fwd, steps)
    out["generate"] = {"s": secs, "launches": launches, "shape": list(hi.shape),
                       "identical": bool(torch.equal(hi, again)),
                       "finite": bool(hi.isfinite().all())}
    print(f"upsampler generate(low_res) 16x16 -> {tuple(hi.shape[1:3])} at n = {BATCH}: "
          f"{secs:.3f} s ({steps} steps), launches {launches} (expected {want}), repeat "
          f"identical {out['generate']['identical']} [{card}]", flush=True)
    expect_bf16_only("upsampler generate")
    if (launches != want or tuple(hi.shape) != (BATCH, 32, 32, 3)
            or not (out["generate"]["identical"] and out["generate"]["finite"])):
        fail(f"the upsampler's generate(low_res=): {out['generate']}")
    try:
        serving.Sampler(lit, state, 32, device=dev)
    except ValueError as e:
        out["serve_refused"] = str(e)
    else:
        fail("serve took a conditioned-input model")
    print(f"serve refused: {out['serve_refused']}", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def f32_cfg_phase(torch, np, blocks, ddpm_models, init_weights, dev, ops, card: str) -> dict:
    """Phase 29: ``LitDDPM(num_classes=10)`` at its default dtype (f32): one
    training step at batch 128 on labelled images (K1/K2/K3 45/45/6 in f32,
    no bf16 kernel); then, on the same weights, the loss and its gradient at
    batch 8 with numpy t and ε, labels with three of eight dropped to the
    null token, and dropout 0.1 on (the card's masks replayed on the CPU and
    in the control), and one guided DDIM step at n = 8 (one call at N = 16,
    w = 2), against f32 on the CPU within ``F32_REL_L2``; the bf16 harness
    on the same inputs is the control that must miss it."""
    from torch.func import functional_call

    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.diffusion import DDIM, classifier_free
    from dmme_tpu_torch.parallel import make_train_step
    from dmme_tpu_torch.training import LitDDPM

    classes = 10
    none = {k: 0 for k in ops}
    w_model = ddpm_models.UNet(dtype=torch.float32, num_classes=classes)
    init_weights(w_model, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, w_model, torch.Generator().manual_seed(SEED + 1))
    weights = {k: v.detach().clone() for k, v in w_model.state_dict().items()}
    dm = CIFAR10(synthetic=True, synthetic_size=2 * TRAIN_BATCH, batch_size=TRAIN_BATCH,
                 with_labels=True)
    dm.setup("fit")
    images, labels = next(dm.train_iter(SEED))
    batch = (torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev))

    lit = LitDDPM(num_classes=classes)
    state = lit.init_state(SEED, device=dev)
    with torch.no_grad():
        for k, v in state.params.items():
            v.copy_(weights[k])
    reset_counts(ops)
    _, metrics = make_train_step(lit.make_loss_fn(dm))(state, batch, SEED)
    torch.cuda.synchronize()
    out = {"train": {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                     "launches": counts(ops), "wide": wide_counts()}}
    print(f"LitDDPM(num_classes={classes}) one training step at batch {TRAIN_BATCH} (f32): loss "
          f"{out['train']['loss']:.6f} grad_norm {out['train']['grad_norm']:.4f}; bf16 kernel "
          f"launches {out['train']['launches']}; f32/fp16 launches {out['train']['wide']}",
          flush=True)
    want_step = wide_expected("f32", PER_TRAIN_STEP)
    if out["train"]["launches"] != none or out["train"]["wide"] != want_step:
        fail(f"the f32 CFG step launched {out['train']}, expected none and {want_step}")
    if not (np.isfinite(out["train"]["loss"]) and np.isfinite(out["train"]["grad_norm"])):
        fail("the f32 CFG training step is not finite")
    del state

    x0, t, eps = ddpm_draws(torch, np)
    r = np.random.default_rng(SEED + 140)
    y = torch.tensor(r.integers(0, classes, (BATCH,)), dtype=torch.int64)
    y[[1, 4, 6]] = classes  # dropped to the null token, as label dropout does
    y_guide = torch.tensor(r.integers(0, classes, (BATCH,)), dtype=torch.int64)
    x_k = torch.tensor(r.standard_normal((BATCH, 32, 32, 3)).astype(np.float32))
    ddim = DDIM.create(1000, 50, "quadratic")
    k_step = 25  # a mid-grid step
    masks = {}

    def measure(dtype, device, replay, count=False):
        model = ddpm_models.UNet(dtype=dtype, num_classes=classes, fused_norm=True,
                                 fused_block=True).to(device)
        params = {k: v.to(device).requires_grad_(True) for k, v in weights.items()}

        def fn(p, x, tt, **kw):
            return functional_call(model, p, (x, tt), kw)

        undo = _dropout_masks(blocks, model, masks, replay)
        try:
            loss = lit.diffusion_model.loss_given(
                lambda p, x, tt, **kw: fn(p, x, tt, y=y.to(device), **kw), params,
                x0.to(device), t.to(device), eps.to(device), train=True,
                generator=torch.Generator(device=device).manual_seed(SEED))
            grads = torch.autograd.grad(loss, list(params.values()))
        finally:
            undo()
        with torch.no_grad():
            p = {k: v.detach() for k, v in params.items()}
            if count:
                torch.cuda.synchronize()
                reset_counts(ops)
            step = ddim.sampling_step(classifier_free(fn, y_guide.to(device), CFG_SCALE, classes),
                                      p, x_k.to(device), k_step)
            if count:
                torch.cuda.synchronize()
                out["ddim_launches"] = {"bf16": counts(ops), "wide": wide_counts()}
        return {"loss": loss.detach().cpu(),
                "grad": torch.cat([g.detach().float().flatten().cpu() for g in grads]),
                "step": step.float().cpu()}

    def readings(got, ref) -> dict:
        return {"loss_rel_err": float(abs(got["loss"] - ref["loss"]) / abs(ref["loss"])),
                "grad_rel_l2": rel_l2(got["grad"], ref["grad"]),
                "step_rel_l2": rel_l2(got["step"], ref["step"])}

    got = measure(torch.float32, dev, False, count=True)
    ref = measure(torch.float32, torch.device("cpu"), True)
    control = measure(torch.bfloat16, dev, True)
    if not all(bool(v.isfinite().all()) for v in got.values()):
        fail("the f32 CFG loss, gradient or guided step on the card is not finite")
    f32_ddim = out["ddim_launches"]
    want_ddim = wide_expected("f32", PER_FORWARD)
    if f32_ddim["bf16"] != none or f32_ddim["wide"] != want_ddim:
        fail(f"the f32 guided DDIM step launched {f32_ddim}, expected none and {want_ddim}")
    out["vs_cpu"] = readings(got, ref)
    out["bf16_control"] = readings(control, ref)
    print(f"f32 CFG card vs f32 CPU (labels {y.tolist()}, {len(masks)} dropout masks replayed; "
          f"guided DDIM step {k_step} of 50 at w = {CFG_SCALE}, launches {f32_ddim}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in out["vs_cpu"].items())
          + f" (<= {F32_REL_L2}); bf16 control: "
          + ", ".join(f"{k} {v:.3e}" for k, v in out["bf16_control"].items()), flush=True)
    if not all(v <= F32_REL_L2 for v in out["vs_cpu"].values()):
        fail("the f32 CFG harness on the card disagrees with the f32 CPU reference")
    if not (out["bf16_control"]["grad_rel_l2"] > F32_REL_L2
            and out["bf16_control"]["step_rel_l2"] > F32_REL_L2):
        fail("the f32 CFG comparison does not tell bf16 compute from f32")
    return out


ADM_GUIDED = "configs/adm/cifar10_guided.yaml"
ADM_CLASSIFIER = "configs/adm/cifar10_classifier.yaml"
ADM_PARAMS, CLASSIFIER_PARAMS = 57_094_662, 4_287_627
CLASSIFIER_BATCH = 256  # configs/adm/cifar10_classifier.yaml's batch size
CLASSES = 10
# K3's call sites a forward: ADM-32 15 (4 heads of 64 at T = 256 ×7, 64 ×7,
# 16 ×1), the classifier-32 5 (2 heads of 64 at T = 256 ×2, 64 ×2, 16 ×1);
# ADM's GroupNorms, SiLUs and ResBlocks are library ops, so K1, K2 and K4
# launch nothing on these paths
ADM_SITES, CLASSIFIER_SITES = 15, 5
PER_FORWARD_ADM = {"group_norm_silu": 0, "group_norm_silu_bwd": 0, "attention": ADM_SITES,
                   "resblock": 0}
# the guided samplers' scale in the request phases (tests/test_adm.py's)
GUIDANCE_SCALE = 1.0
# steps of the guided request, and of the timed ancestral guided loop
GUIDED_STEPS, GUIDED_DDPM_TIMED = 25, 10
# the ADM generator's respaced steps when served (phase 34)
ADM_SERVE_STEPS = 25


def adm_targets(k_attn, adm, backward: bool):
    """ADM's kernel entry point (``models/adm.py`` calls ``attention_heads``
    from its own namespace), and with ``backward`` the attention backward."""
    targets = [(adm, "attention_heads", "attention", _sig_attn)]
    if backward:
        targets.append((k_attn, "attention_bwd", "attention_bwd", _sig_attn))
    return targets


def adm_harness(torch, blocks, which: str, dtype: str = "bf16", argv=()):
    """(harness, weights) of ``configs/adm/<which>.yaml`` with its model in
    ``dtype`` (and ``argv`` applied): the seed's weights with every bias,
    GroupNorm affine and zero-initialised kernel drawn at random, on the
    CPU in f32, loaded into the harness's model."""
    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.models import init_weights

    key = ("--model.init_args.model.init_args.dtype" if which == "cifar10_guided"
           else "--model.init_args.dtype")
    cfg = tcfg.apply_overrides(tcfg.load_config(f"configs/adm/{which}.yaml"),
                               [key, dtype, *argv])
    lit = tcfg.instantiate(tcfg.validate_config(cfg)["model"])
    init_weights(lit.model, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, lit.model, torch.Generator().manual_seed(SEED + 1))
    return lit, {k: v.detach().clone() for k, v in lit.model.state_dict().items()}


def _on(weights: dict, dev) -> dict:
    return {k: v.to(dev) for k, v in weights.items()}


def adm_kernels(torch, np, blocks, k_gn, k_attn, k_res, build, dev, ops, card: str) -> dict:
    """Phase 30: K3 at ADM's call sites. The ADM-32 generator of
    configs/adm/cifar10_guided.yaml (57,094,662 parameters, bf16, every
    weight random): its 15 sites at serving forwards of n = 1, 8 and 16 and
    at one ``LitIDDPM`` training step at batch 128 (K3 and its backward);
    the classifier-32 of configs/adm/cifar10_classifier.yaml (4,287,627): its
    5 sites at one ``LitClassifier`` step at batch 256, and both models' 20
    (and the classifier's 5 backward) inside one ``ClassifierGuidedDDIM``
    step at n = 8. Each call held against its plain version (``TOL``) and
    timed beside its bound, SDPA and the plain time; K1, K2 and K4 launch
    nothing and no f32, fp16 or ``simt.cu`` counter moves."""
    import dataclasses

    from dmme_tpu_torch.diffusion import ClassifierGuidedDDIM
    from dmme_tpu_torch.models import adm, eps_only, init_weights

    lit, weights = adm_harness(torch, blocks, "cifar10_guided")
    n_params = sum(p.numel() for p in lit.model.parameters())
    print(f"{ADM_GUIDED}: {type(lit).__name__} with {type(lit.model).__name__}, "
          f"{n_params:,} parameters (expected {ADM_PARAMS:,})", flush=True)
    if n_params != ADM_PARAMS:
        fail(f"ADM-32 has {n_params} parameters")
    m = lit.model.to(dev).eval()
    runs = {}
    for n in SERVE_BATCHES:
        g = torch.Generator().manual_seed(SEED + 150 + n)
        runs[f"adm_n{n}"] = (m, torch.randn((n, 32, 32, 3), generator=g),
                             torch.randint(1, 1000, (n,), generator=g),
                             {"attention": ADM_SITES})
    reset_counts(ops)
    recorded, _ = record_forwards(torch, blocks, runs, dev, adm_targets(k_attn, adm, False))
    torch.cuda.synchronize()
    launches = counts(ops)
    expect_bf16_only("ADM forwards")
    want = launches_for(PER_FORWARD_ADM, len(runs))
    print(f"ADM forwards at n = {SERVE_BATCHES}: launches {launches} (expected {want})",
          flush=True)
    if launches != want:
        fail(f"the ADM forwards launched {launches}, expected {want}")
    rows, failures = forward_rows(torch, k_gn, k_attn, k_res, build, dev, recorded)
    if failures:
        fail(f"ADM forward kernels disagree with their plain versions: {failures}")
    out = {"params": n_params, "forward_rows": rows, "forward_launches": launches,
           "per_forward": {name: _per_forward(rows, name, card, f"ADM forward, {name}",
                                              ("attention",)) for name in runs}}
    del m, recorded
    torch.cuda.empty_cache()

    print(f"-- LitIDDPM(ADM-32) training step at batch {TRAIN_BATCH}", flush=True)
    out["train"] = train_kernels(
        torch, blocks, k_gn, k_attn, None, init_weights, None, dev, card, ops,
        lit=adm_harness(torch, blocks, "cifar10_guided")[0],
        targets=adm_targets(k_attn, adm, True),
        sites={"attention": ADM_SITES, "attention_bwd": ADM_SITES})
    torch.cuda.empty_cache()
    print(f"-- LitClassifier(classifier-32) training step at batch {CLASSIFIER_BATCH}",
          flush=True)
    clf, clf_weights = adm_harness(torch, blocks, "cifar10_classifier")
    n_clf = sum(p.numel() for p in clf.model.parameters())
    if n_clf != CLASSIFIER_PARAMS:
        fail(f"the classifier-32 has {n_clf} parameters, expected {CLASSIFIER_PARAMS}")
    out["classifier_train"] = train_kernels(
        torch, blocks, k_gn, k_attn, None, init_weights, None, dev, card, ops, lit=clf,
        batch_size=CLASSIFIER_BATCH, labels=CLASSES, targets=adm_targets(k_attn, adm, True),
        sites={"attention": CLASSIFIER_SITES, "attention_bwd": CLASSIFIER_SITES})
    torch.cuda.empty_cache()

    print(f"-- one ClassifierGuidedDDIM step at n = {BATCH}", flush=True)
    algo = dataclasses.replace(ClassifierGuidedDDIM.create(1000, GUIDED_STEPS,
                                                           guidance_scale=GUIDANCE_SCALE),
                               schedule=lit.diffusion_model.schedule)
    gp, cp = _on(weights, dev), _on(clf_weights, dev)
    lit.model.to(dev)
    clf.model.to(dev)
    g = torch.Generator().manual_seed(SEED + 160)
    x = torch.randn((BATCH, 32, 32, 3), generator=g).to(dev)
    y = torch.randint(0, CLASSES, (BATCH,), generator=g).to(dev)

    def step():
        with torch.no_grad():  # as inside guided_generate
            algo.guided_sampling_step(eps_only(lit.model_fn), gp, clf.model_fn, cp, y, x,
                                      GUIDED_STEPS // 2)

    reset_counts(ops)
    calls = record_calls(adm_targets(k_attn, adm, True), step)
    torch.cuda.synchronize()
    launches = counts(ops)
    expect_bf16_only("guided DDIM step")
    sites = {k: sum(c for _, c, _, _ in v) for k, v in calls.items()}
    want_sites = {"attention": ADM_SITES + CLASSIFIER_SITES, "attention_bwd": CLASSIFIER_SITES}
    want = dict(PER_FORWARD_ADM, attention=ADM_SITES + CLASSIFIER_SITES)
    print(f"guided DDIM step at n = {BATCH}: call sites {sites}, launches {launches}", flush=True)
    if sites != want_sites or launches != want:
        fail(f"the guided step has call sites {sites} and launches {launches}, expected "
             f"{want_sites} and {want}")
    rows, per_step = step_rows(torch, k_gn, k_attn, calls, card,
                               f"per guided DDIM step at n = {BATCH}")
    out["guided_step"] = {"rows": rows, "per_step": per_step, "launches": launches}
    del lit, clf, gp, cp
    torch.cuda.empty_cache()
    return out


def _loss_and_grads(torch, lit, weights, device, inputs, labels=None):
    """The harness's deterministic loss core and every parameter's gradient
    on ``device``: ``loss_given`` of the IDDPM hybrid loss (generator) or of
    the classifier's cross-entropy (``labels``), on numpy-drawn ``inputs``
    (x₀, t, ε)."""
    lit.model.to(device)
    params = {k: v.to(device).requires_grad_(True) for k, v in weights.items()}
    x0, t, eps = (v.to(device) for v in inputs)
    if labels is None:
        loss = lit.diffusion_model.loss_given(lit.model_fn, params, x0, t, eps, train=True)
    else:
        loss = lit.loss_given(params, x0, labels.to(device), t, eps, train=True)
    grads = torch.autograd.grad(loss, list(params.values()))
    return {"loss": loss.detach().cpu(),
            "grads": {k: g.detach().float().cpu() for k, g in zip(params, grads)}}


def adm_vs_cpu(torch, np, blocks, dev, ops, card: str) -> dict:
    """Phase 31: ADM-32 and the classifier-32 on the card against f32 on the
    CPU, on the same random weights and numpy inputs at batch 8: the bf16
    generator's forward (``UNET_REL_L2``) and its hybrid-loss gradient with
    one sample at t = 1 (the variance head conditioned, ``VAR_HEAD_COND``;
    ``GRAD_REL_L2``); the default-dtype (f32) ``LitIDDPM(model=ADM)`` and
    ``LitClassifier()`` loss and gradient within ``F32_REL_L2``, each with a
    bf16 control on the same inputs that must miss it; and
    ``classifier_grad`` at n = 8 (bf16 within ``GRAD_REL_L2``, f32 within
    ``F32_REL_L2``). The f32 paths launch K3 in f32 only."""
    from dmme_tpu_torch.diffusion import classifier_grad

    none = {k: 0 for k in ops}
    r = np.random.default_rng(SEED + 170)
    x0 = torch.tensor(np.clip(r.standard_normal((BATCH, 32, 32, 3)), -1, 1).astype(np.float32))
    t = torch.tensor(r.integers(1, 1000, (BATCH,)), dtype=torch.int64)
    t[0] = 1
    eps = torch.tensor(r.standard_normal((BATCH, 32, 32, 3)).astype(np.float32))
    y = torch.tensor(r.integers(0, CLASSES, (BATCH,)), dtype=torch.int64)
    x_in = torch.tensor(r.standard_normal((BATCH, 32, 32, 3)).astype(np.float32))
    out = {}

    gen = {d: adm_harness(torch, blocks, "cifar10_guided", d) for d in ("bf16", "f32")}
    weights = condition_var_head(gen["f32"][1], "out_conv")
    ref_lit = gen["f32"][0]
    # the bf16 forward at n = 8
    gen["bf16"][0].model.load_state_dict(weights)
    with torch.no_grad():
        want = ref_lit.model_fn(weights, x_in, t).float()
        reset_counts(ops)
        got = gen["bf16"][0].model.to(dev)(x_in.to(dev), t.to(dev)).float().cpu()
        torch.cuda.synchronize()
    fwd_launches = counts(ops)
    expect_bf16_only("ADM forward vs the CPU")
    out["forward_rel_l2"] = rel_l2(got, want)
    print(f"ADM-32 bf16 forward at n = {BATCH} vs f32 CPU: rel L2 {out['forward_rel_l2']:.3e} "
          f"(<= {UNET_REL_L2}), launches {fwd_launches}", flush=True)
    if not (out["forward_rel_l2"] <= UNET_REL_L2 and bool(got.isfinite().all())
            and fwd_launches == PER_FORWARD_ADM):
        fail(f"the ADM forward on the card: rel L2 {out['forward_rel_l2']}, launches "
             f"{fwd_launches}")

    def readings(a, b) -> dict:
        flat = torch.cat([a["grads"][k].flatten() for k in a["grads"]])
        ref = torch.cat([b["grads"][k].flatten() for k in a["grads"]])
        return {"loss_rel_err": float(abs(a["loss"] - b["loss"]) / abs(b["loss"])),
                "grad_rel_l2": rel_l2(flat, ref)}

    inputs = (x0, t, eps)
    ref = _loss_and_grads(torch, ref_lit, weights, torch.device("cpu"), inputs)
    reset_counts(ops)
    bf16 = _loss_and_grads(torch, gen["bf16"][0], weights, dev, inputs)
    torch.cuda.synchronize()
    bf16_launches = counts(ops)
    expect_bf16_only("ADM training step vs the CPU")
    bad = [k for k, g in bf16["grads"].items()
           if not bool(g.isfinite().all()) or float(g.abs().max()) == 0.0]
    if bad or bf16_launches != PER_FORWARD_ADM:
        fail(f"ADM gradients zero or not finite on the card: {bad[:10]}; launches "
             f"{bf16_launches}")
    reset_counts(ops)
    f32 = _loss_and_grads(torch, ref_lit, weights, dev, inputs)
    torch.cuda.synchronize()
    f32_launches = {"bf16": counts(ops), "wide": wide_counts()}
    out["adm"] = {"bf16": readings(bf16, ref), "f32": readings(f32, ref), "t": t.tolist(),
                  "f32_launches": f32_launches}
    print(f"LitIDDPM(ADM-32) hybrid loss + gradient at batch {BATCH} (t {t.tolist()}), card "
          f"vs f32 CPU: bf16 {out['adm']['bf16']} (<= {GRAD_REL_L2}); f32 "
          f"{out['adm']['f32']} (<= {F32_REL_L2}), launches {f32_launches}", flush=True)
    if not all(v <= GRAD_REL_L2 for v in out["adm"]["bf16"].values()):
        fail("the bf16 ADM loss or gradient is too far from the CPU's")
    if (f32_launches["bf16"] != none
            or f32_launches["wide"] != wide_expected("f32", PER_FORWARD_ADM)):
        fail(f"the f32 ADM step launched {f32_launches}")
    if not all(v <= F32_REL_L2 for v in out["adm"]["f32"].values()):
        fail("the f32 LitIDDPM(ADM) harness disagrees with the f32 CPU reference")
    if not out["adm"]["bf16"]["grad_rel_l2"] > F32_REL_L2:
        fail("the ADM comparison does not tell bf16 compute from f32")
    del gen, ref, bf16, f32, ref_lit
    torch.cuda.empty_cache()

    clf = {d: adm_harness(torch, blocks, "cifar10_classifier", d) for d in ("bf16", "f32")}
    cw = clf["f32"][1]
    clf["bf16"][0].model.load_state_dict(cw)
    ref = _loss_and_grads(torch, clf["f32"][0], cw, torch.device("cpu"), inputs, y)
    bf16 = _loss_and_grads(torch, clf["bf16"][0], cw, dev, inputs, y)
    reset_counts(ops)
    f32 = _loss_and_grads(torch, clf["f32"][0], cw, dev, inputs, y)
    torch.cuda.synchronize()
    f32_launches = {"bf16": counts(ops), "wide": wide_counts()}
    want_clf = dict(PER_FORWARD_ADM, attention=CLASSIFIER_SITES)
    out["classifier"] = {"bf16": readings(bf16, ref), "f32": readings(f32, ref),
                         "f32_launches": f32_launches}
    print(f"LitClassifier() cross-entropy + gradient at batch {BATCH}, card vs f32 CPU: f32 "
          f"{out['classifier']['f32']} (<= {F32_REL_L2}), launches {f32_launches}; bf16 "
          f"control {out['classifier']['bf16']}", flush=True)
    if (f32_launches["bf16"] != none
            or f32_launches["wide"] != wide_expected("f32", want_clf)):
        fail(f"the f32 classifier step launched {f32_launches}")
    if not all(v <= F32_REL_L2 for v in out["classifier"]["f32"].values()):
        fail("the f32 LitClassifier harness disagrees with the f32 CPU reference")
    if not out["classifier"]["bf16"]["grad_rel_l2"] > F32_REL_L2:
        fail("the classifier comparison does not tell bf16 compute from f32")

    # ∇ₓ log p(y | x_t, t) at n = 8, as every guided step takes it
    grads = {}
    for name, device in (("cpu", torch.device("cpu")), ("bf16", dev), ("f32", dev)):
        lit_ = clf["f32" if name == "cpu" else name][0]
        lit_.model.to(device)
        with torch.no_grad():
            grads[name] = classifier_grad(lit_.model_fn, _on(cw, device), y.to(device),
                                          x_in.to(device), t.to(device)).float().cpu()
    out["classifier_grad"] = {d: rel_l2(grads[d], grads["cpu"]) for d in ("bf16", "f32")}
    print(f"classifier_grad at n = {BATCH}, card vs f32 CPU: bf16 rel L2 "
          f"{out['classifier_grad']['bf16']:.3e} (<= {GRAD_REL_L2}), f32 "
          f"{out['classifier_grad']['f32']:.3e} (<= {F32_REL_L2})", flush=True)
    if not (out["classifier_grad"]["bf16"] <= GRAD_REL_L2
            and out["classifier_grad"]["f32"] <= F32_REL_L2
            and float(grads["cpu"].abs().max()) > 0):
        fail(f"classifier_grad on the card disagrees with the CPU: {out['classifier_grad']}")
    del clf
    torch.cuda.empty_cache()
    return out


def adm_cli(torch, np, ops, dev, card: str) -> dict:
    """Phase 32: ``trainer.main fit`` of configs/adm/cifar10_guided.yaml (the
    ADM generator, bf16, batch 128) and configs/adm/cifar10_classifier.yaml
    (the noisy classifier, bf16, batch 256, labelled) on synthetic
    CIFAR-10, 10 steps each with a checkpoint at 10 (K3 15 and 5 launches
    a step, nothing else); the classifier resumed to 20 against an
    uninterrupted 20-step run, bit for bit (deterministic cuDNN); then each
    saved state's train step timed (10 steps: median, device busy,
    operations, idle share) under the library's default cuDNN settings."""
    import shutil

    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.parallel import make_train_step
    from dmme_tpu_torch.training import CheckpointManager

    torch.backends.cudnn.deterministic = True
    roots = {k: os.path.join("build", k) for k in ("cli_adm", "cli_clf", "cli_clf_whole")}
    for root in roots.values():
        shutil.rmtree(root, ignore_errors=True)
    common = ["--data.init_args.synthetic", "true", "--data.init_args.synthetic_size", "1024",
              "--trainer.ckpt_every_n_steps", "10", "--trainer.log_every_n_steps", "10"]
    per_step = {"cifar10_guided": dict(PER_FORWARD_ADM),
                "cifar10_classifier": dict(PER_FORWARD_ADM, attention=CLASSIFIER_SITES)}

    def steps(which, n):
        return {k: v * n for k, v in per_step[which].items()}

    def run(which, name, root, max_steps, n_steps, *extra):
        return cli_run(torch, ops, card, name,
                       ["fit", "--config", f"configs/adm/{which}.yaml", *common,
                        "--trainer.max_steps", str(max_steps), "--trainer.default_root_dir",
                        root, *extra], steps(which, n_steps))

    out = {"fit": run("cifar10_guided", "adm fit 10", roots["cli_adm"], 10, 10),
           "classifier_fit": run("cifar10_classifier", "classifier fit 10", roots["cli_clf"],
                                 10, 10)}
    for key, root in (("fit", roots["cli_adm"]), ("classifier_fit", roots["cli_clf"])):
        logged = _jsonl(os.path.join(root, "metrics.jsonl"))
        out[key]["losses"] = [r["loss"] for r in logged]
        out[key]["checkpoints"] = CheckpointManager(root).steps()
        print(f"{key}: checkpoints {out[key]['checkpoints']}, losses {out[key]['losses']}",
              flush=True)
        if out[key]["checkpoints"] != [10] or not np.isfinite(out[key]["losses"]).all():
            fail(f"the ADM CLI {key} left {out[key]}")
    out["resume"] = run("cifar10_classifier", "classifier resume 10 -> 20", roots["cli_clf"],
                        20, 10, "--trainer.resume", "true")
    out["whole"] = run("cifar10_classifier", "classifier uninterrupted 20",
                       roots["cli_clf_whole"], 20, 20)
    a = CheckpointManager(roots["cli_clf"]).load(20)
    b = CheckpointManager(roots["cli_clf_whole"]).load(20)
    differ = state_differences(torch, a, b)
    out["resume_bitwise"] = {"differing_tensors": len(differ), "first": differ[:8]}
    print(f"classifier resumed vs uninterrupted at step 20: {len(differ)} of "
          f"{4 * len(a['params'])} tensors differ {differ[:8]}", flush=True)
    if differ or a["step"] != b["step"]:
        fail(f"the resumed classifier run is not bitwise the uninterrupted one: {differ[:8]}")

    torch.backends.cudnn.deterministic = False
    for which, root, key, bs in (("cifar10_guided", roots["cli_adm"], "timing", TRAIN_BATCH),
                                 ("cifar10_classifier", roots["cli_clf"], "classifier_timing",
                                  CLASSIFIER_BATCH)):
        lit = tcfg.instantiate(tcfg.validate_config(
            tcfg.load_config(f"configs/adm/{which}.yaml"))["model"])
        state = CheckpointManager(root).restore(lit.init_state(0, device=dev))
        labelled = which == "cifar10_classifier"
        dm = CIFAR10(synthetic=True, synthetic_size=4 * bs, batch_size=bs,
                     with_labels=labelled)
        dm.setup("fit")
        it = dm.train_iter(SEED + 11)

        def batch(it=it, labelled=labelled):
            b = next(it)
            if labelled:
                return (torch.from_numpy(b[0]).pin_memory().to(dev, non_blocking=True),
                        torch.from_numpy(b[1]).to(dev))
            return torch.from_numpy(b).pin_memory().to(dev, non_blocking=True)

        step = make_train_step(lit.make_loss_fn(dm))
        state, _ = step(state, batch(), SEED)  # first launches of this step object
        print(f"-- {which}: the saved state's train step at batch {bs}", flush=True)
        _, out[key], out[f"{key}_profile_3_steps"], out[f"{key}_profile_1_step"] = timed_steps(
            torch, np, step, state, batch, card, batch_size=bs)
        del state, lit
    for root in roots.values():
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def adm_guidance(torch, np, blocks, dev, ops, card: str) -> dict:
    """Phase 33: classifier-guided sampling on the card. The bf16 ADM-32 of
    configs/adm/cifar10_guided.yaml (ε of its ε ‖ v, ``eps_only``) with the
    bf16 classifier-32, random weights, guidance scale ``GUIDANCE_SCALE``:
    a ``ClassifierGuidedDDIM`` ``GUIDED_STEPS``-step request at n = 8 on the trained
    cosine schedule (the dataclass built with it), after a warm one: wall
    time, launches (20 K3 calls a step: 15 generator, 5 classifier, none of
    K1, K2 or K4), finite, identical bytes for a repeated seed
    (deterministic cuDNN); one under torch.profiler (busy, operations, idle
    share); then 20 steps of ``ClassifierGuidedDDPM`` timed and
    extrapolated to T = 1000."""
    import dataclasses

    from dmme_tpu_torch.diffusion import ClassifierGuidedDDIM, ClassifierGuidedDDPM
    from dmme_tpu_torch.models import eps_only

    torch.backends.cudnn.deterministic = True
    lit, weights = adm_harness(torch, blocks, "cifar10_guided")
    clf, clf_weights = adm_harness(torch, blocks, "cifar10_classifier")
    lit.model.to(dev)
    clf.model.to(dev)
    gp, cp = _on(weights, dev), _on(clf_weights, dev)
    schedule = lit.diffusion_model.schedule
    ddim = dataclasses.replace(ClassifierGuidedDDIM.create(1000, GUIDED_STEPS,
                                                           guidance_scale=GUIDANCE_SCALE),
                               schedule=schedule)
    y = (torch.arange(BATCH) % CLASSES).to(dev)
    gen_fn = eps_only(lit.model_fn)

    def request(seed):
        out = ddim.guided_generate(gen_fn, gp, clf.model_fn, cp, y,
                                   torch.Generator(device=dev).manual_seed(seed),
                                   (BATCH, 32, 32, 3))
        torch.cuda.synchronize()
        return out

    request(1)  # warm: cuDNN plans, first buffers
    reset_counts(ops)
    t0 = time.perf_counter()
    a = request(2)
    wall = time.perf_counter() - t0
    launches = counts(ops)
    expect_bf16_only("guided DDIM request")
    b = request(2)
    want = launches_for(dict(PER_FORWARD_ADM, attention=ADM_SITES + CLASSIFIER_SITES),
                        GUIDED_STEPS)
    out = {"wall_s": wall, "launches": launches, "identical": bool(torch.equal(a, b)),
           "finite": bool(a.isfinite().all()), "std": float(a.float().std()),
           "absmax": float(a.float().abs().max())}
    print(f"ClassifierGuidedDDIM {GUIDED_STEPS} steps at n = {BATCH} (scale {GUIDANCE_SCALE}, "
          f"the trained cosine schedule): {wall:.3f} s, launches {launches} (expected {want}), "
          f"finite {out['finite']}, std {out['std']:.4g}, max |x| {out['absmax']:.4g}, repeat "
          f"{'identical' if out['identical'] else 'DIFFERENT'} [{card}]", flush=True)
    if not (out["identical"] and out["finite"]) or launches != want:
        fail(f"the guided DDIM request: {out}")
    prof = profile_fn(torch, lambda: request(3))
    out["profile"] = prof
    print(f"guided DDIM-{GUIDED_STEPS} n = {BATCH} under torch.profiler: wall "
          f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} ms in "
          f"{prof['device_ops']} operations, idle share {prof['idle_share']:.3f} [{card}]",
          flush=True)
    for name, ms, count in prof["top"]:
        print(f"    {ms:9.3f} ms {count:6d}x  {name}", flush=True)

    ddpm = dataclasses.replace(ClassifierGuidedDDPM.create(1000, GUIDANCE_SCALE),
                               schedule=schedule).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((BATCH, 32, 32, 3), generator=g, device=dev)
    with torch.no_grad():
        x = ddpm.guided_sampling_step(gen_fn, gp, clf.model_fn, cp, y, x, 1000, g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(999, 999 - GUIDED_DDPM_TIMED, -1):
            x = ddpm.guided_sampling_step(gen_fn, gp, clf.model_fn, cp, y, x, t, g)
        torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / GUIDED_DDPM_TIMED
    out["ddpm"] = {"step_s": per_step, "request_s_extrapolated": 1000 * per_step,
                   "finite": bool(x.isfinite().all())}
    print(f"ClassifierGuidedDDPM at n = {BATCH}: {1e3 * per_step:.3f} ms a step "
          f"({GUIDED_DDPM_TIMED} steps, host clock), so {1000 * per_step:.1f} s a T = 1000 "
          f"request [{card}]", flush=True)
    if not out["ddpm"]["finite"]:
        fail("the guided DDPM steps are not finite")
    del lit, clf, gp, cp
    torch.cuda.empty_cache()
    return out


def adm_serve(torch, np, blocks, dev, ops, card: str) -> dict:
    """Phase 34: the ADM generator served. ``LitIDDPM`` of
    configs/adm/cifar10_guided.yaml with ``sample_steps=ADM_SERVE_STEPS``
    (bf16, random weights) behind ``make_server``: ``default`` requests (the
    respaced ancestral sampler) at n = 1, 8 and 16 and a repeat of 8 with
    identical bytes (launches 15 K3 a forward, nothing else); ``ddim`` at
    n = 8; ``cached``, ``deep`` and ``deep_dpm`` answered 400, as for every
    variance-learning model; one n = 8 ``default`` request under the
    profiler."""
    from dmme_tpu_torch.serving import Sampler
    from dmme_tpu_torch.training import TrainState

    lit, weights = adm_harness(torch, blocks, "cifar10_guided",
                               argv=["--model.init_args.sample_steps", str(ADM_SERVE_STEPS)])
    state = TrainState.create(weights, lit.make_optimizer())
    sampler = Sampler(lit, state, img_size=32, device=dev)
    url, stop = _serve(torch, sampler)
    out = {}
    try:
        out["requests"], launches = default_requests(np, url, ops, "ADM", card)
        want = launches_for(PER_FORWARD_ADM, ADM_SERVE_STEPS * 4)
        print(f"ADM: launches during the four default requests {launches} (expected {want})",
              flush=True)
        if launches != want:
            fail(f"ADM serve launched {launches}, expected {want}")
        out["launches"] = launches
        out["solvers"] = solver_requests(np, url, ops, "ADM", card, [
            ("ddim", ADM_SERVE_STEPS, launches_for(PER_FORWARD_ADM, ADM_SERVE_STEPS))])
        out["rejected"] = {name: rejected(url, "ADM", name, "variance-learning")
                           for name, _, _ in CACHING}
    finally:
        stop()
    prof = profile_fn(torch, lambda: sampler.sample(BATCH, seed=5))
    out["profile_n8"] = prof
    print(f"ADM default n=8 under torch.profiler: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['busy_ms']:.2f} ms in {prof['device_ops']} operations, idle share "
          f"{prof['idle_share']:.3f} [{card}]", flush=True)
    for name, ms, count in prof["top"]:
        print(f"    {ms:9.3f} ms {count:6d}x  {name}", flush=True)
    del sampler, state
    torch.cuda.empty_cache()
    return out


DIT_CONFIG = "configs/flow/cifar10_dit.yaml"
MOE_CONFIG = "configs/flow/cifar10_dit_moe.yaml"
DIT_PARAMS, MOE_PARAMS = 32_499_120, 82_143_456
# K3's call sites a DiT-S/4 forward: 12 blocks of 6 heads of 64 at T = 64;
# the DiT has no GroupNorm and no ResBlock, so K1, K2 and K4 launch nothing
DIT_SITES = 12
PER_FORWARD_DIT = {"group_norm_silu": 0, "group_norm_silu_bwd": 0, "attention": DIT_SITES,
                   "resblock": 0}
# the DiT CLI fits: steps before the resume, and in all
DIT_FIT_HALF, DIT_FIT_STEPS = 5, 10
# progressive distillation of configs/ddpm/cifar10.yaml: the first student's
# steps (the ε teacher samples in 1000), rounds, train steps a round
DISTILL_START, DISTILL_ROUNDS, DISTILL_STEPS = 100, 2, 3
# launches of one distillation step at batch 128: the teacher's two pure
# forwards (K1 at out_norm, K3 6 and K4 22 each), the student's training
# forward and backward (K1 45, K2 45, K3 6)
PER_DISTILL_STEP = {"group_norm_silu": 45 + 2, "group_norm_silu_bwd": 45, "attention": 6 + 12,
                    "resblock": 2 * 22}
# what the distillation driver may leave allocated on the card once it
# returns (a round's teacher or student state is ≈ 0.1–0.5 GiB)
DRIVER_LEFT_BYTES = 32 * 2**20
# inpainting: LitDDPM's UNet and a DDPM of INPAINT_T steps at n = 8, the
# left half known, RePaint harmonisation repeats (each step's forward is the
# n = 8 serving forward whatever T is, so T sets only the depth)
INPAINT_T, INPAINT_RESAMPLE = 100, 2


def dit_harness(torch, blocks, path: str, dtype: str = "bf16", argv=()):
    """(harness, weights) of the DiT config ``path`` with harness and model in
    ``dtype`` (and ``argv`` applied): the seed's weights with every bias,
    adaLN-Zero kernel and expert bias drawn at random, on the CPU in f32,
    loaded into the harness's model."""
    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.models import init_weights

    cfg = tcfg.apply_overrides(tcfg.load_config(path), [
        "--model.init_args.dtype", dtype, "--model.init_args.model.init_args.dtype", dtype,
        *argv])
    lit = tcfg.instantiate(tcfg.validate_config(cfg)["model"])
    init_weights(lit.model, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, lit.model, torch.Generator().manual_seed(SEED + 1))
    return lit, {k: v.detach().clone() for k, v in lit.model.state_dict().items()}


def dit_targets(k_attn, backward: bool):
    """The DiT's kernel entry point (``models/dit.py`` calls ``attention_heads``
    from its own namespace), and with ``backward`` the attention backward."""
    from dmme_tpu_torch.models import dit

    targets = [(dit, "attention_heads", "attention", _sig_attn)]
    if backward:
        targets.append((k_attn, "attention_bwd", "attention_bwd", _sig_attn))
    return targets


def dit_kernels(torch, np, blocks, k_gn, k_attn, k_res, build, dev, ops, card: str) -> dict:
    """Phase 35: K3 at the DiT's call sites. DiT-S/4 of configs/flow/
    cifar10_dit.yaml (32,499,120 parameters) and the MoE-DiT of
    cifar10_dit_moe.yaml (82,143,456; 8 experts, top-2, in blocks 1, 3, …,
    11), bf16, every weight random: the 12 sites (6 heads of 64 at T = 64,
    q, k and v strided views of the qkv projection) at serving forwards of
    n = 8 and at one ``LitFlow`` training step at batch 128 of each (K3 and
    its backward), each held against its plain version (``TOL``) and timed
    beside SDPA; K1, K2 and K4 launch nothing."""
    from dmme_tpu_torch.models import init_weights

    out = {"forward_rows": [], "per_forward": {}}
    for key, path, want_params in (("dit", DIT_CONFIG, DIT_PARAMS),
                                   ("moe", MOE_CONFIG, MOE_PARAMS)):
        lit, _ = dit_harness(torch, blocks, path)
        n_params = sum(p.numel() for p in lit.model.parameters())
        print(f"{path}: {type(lit).__name__} with {type(lit.model).__name__}, {n_params:,} "
              f"parameters (expected {want_params:,})", flush=True)
        if n_params != want_params:
            fail(f"{path} has {n_params} parameters")
        g = torch.Generator().manual_seed(SEED + 200)
        runs = {f"{key}_n{BATCH}": (lit.model.to(dev).eval(),
                                    torch.randn((BATCH, 32, 32, 3), generator=g),
                                    1000.0 * torch.rand((BATCH,), generator=g),
                                    {"attention": DIT_SITES})}
        reset_counts(ops)
        recorded, _ = record_forwards(torch, blocks, runs, dev, dit_targets(k_attn, False))
        torch.cuda.synchronize()
        launches = counts(ops)
        expect_bf16_only(f"{key} forward")
        print(f"{key} forward at n = {BATCH}: launches {launches} (expected {PER_FORWARD_DIT})",
              flush=True)
        if launches != PER_FORWARD_DIT:
            fail(f"the {key} forward launched {launches}, expected {PER_FORWARD_DIT}")
        rows, failures = forward_rows(torch, k_gn, k_attn, k_res, build, dev, recorded)
        if failures:
            fail(f"{key} forward kernels disagree with their plain versions: {failures}")
        out["forward_rows"] += rows
        name = f"{key}_n{BATCH}"
        out["per_forward"][key] = _per_forward(rows, name, card, f"{key} forward, {name}",
                                               ("attention",))
        del lit, runs, recorded
        torch.cuda.empty_cache()

        print(f"-- LitFlow({key}) training step at batch {TRAIN_BATCH}", flush=True)
        out[f"{key}_train"] = train_kernels(
            torch, blocks, k_gn, k_attn, None, init_weights, None, dev, card, ops,
            lit=dit_harness(torch, blocks, path)[0], targets=dit_targets(k_attn, True),
            sites={"attention": DIT_SITES, "attention_bwd": DIT_SITES})
        torch.cuda.empty_cache()
    return out


def _flow_loss_and_grads(torch, lit, weights, device, inputs):
    """The flow harness's loss core with the routers' losses (``loss_given``
    through ``loss_model_fn`` and ``add_moe_aux``, training mode, no draws)
    and every parameter's gradient on ``device``, with the MoE blocks'
    round-1 routed fractions of that call."""
    lit.model.to(device)
    params = {k: v.to(device).requires_grad_(True) for k, v in weights.items()}
    x0, t, x1 = (v.to(device) for v in inputs)
    box, stats = [], []
    model_fn = lit.model_fn

    def spy(p, x, tt, **kw):  # keeps the MoE blocks' statistics beside the collector
        out = model_fn(p, x, tt, **kw)
        stats.extend(kw.get("moe_losses") or [])
        return out

    lit.model_fn = spy
    try:
        loss = lit.add_moe_aux(lit.diffusion_model.loss_given(lit.loss_model_fn(box), params,
                                                              x0, t, x1, train=True), box)
    finally:
        del lit.model_fn
    grads = torch.autograd.grad(loss, list(params.values()))
    return {"loss": loss.detach().cpu(),
            "grads": {k: g.detach().float().cpu() for k, g in zip(params, grads)},
            "f_e": [s["f_e"].detach().cpu() for s in stats]}


def dit_vs_cpu(torch, np, blocks, dev, ops, card: str) -> dict:
    """Phase 36: DiT-S/4 and the MoE-DiT on the card against f32 on the CPU,
    on the same random weights and numpy inputs at batch 8: the bf16 DiT
    forward (``UNET_REL_L2``); the default-dtype (f32) harness's flow loss
    (routers' losses included, training-mode routing) and gradient within
    ``F32_REL_L2``, each with a bf16 control on the same inputs that must
    miss it. The f32 paths launch K3 in f32 only, 12 a forward."""
    none = {k: 0 for k in ops}
    r = np.random.default_rng(SEED + 210)
    x0 = torch.tensor(np.clip(r.standard_normal((BATCH, 32, 32, 3)), -1, 1).astype(np.float32))
    t = torch.tensor(r.uniform(0.02, 0.98, (BATCH,)).astype(np.float32))
    x1 = torch.tensor(r.standard_normal((BATCH, 32, 32, 3)).astype(np.float32))
    out = {}
    for key, path in (("dit", DIT_CONFIG), ("moe", MOE_CONFIG)):
        lits = {d: dit_harness(torch, blocks, path, d) for d in ("bf16", "f32")}
        weights = lits["f32"][1]
        ref_lit, bf16_lit = lits["f32"][0], lits["bf16"][0]
        bf16_lit.model.load_state_dict(weights)
        with torch.no_grad():
            want = ref_lit.model_fn(weights, x0, 1000.0 * t).float()
            reset_counts(ops)
            got = bf16_lit.model.to(dev)(x0.to(dev), (1000.0 * t).to(dev)).float().cpu()
            torch.cuda.synchronize()
        fwd_launches = counts(ops)
        expect_bf16_only(f"{key} forward vs the CPU")
        rec = {"forward_rel_l2": rel_l2(got, want)}
        print(f"{key} bf16 forward at n = {BATCH} vs f32 CPU: rel L2 {rec['forward_rel_l2']:.3e} "
              f"(<= {UNET_REL_L2} for the dense DiT), launches {fwd_launches}", flush=True)
        if not (bool(got.isfinite().all()) and fwd_launches == PER_FORWARD_DIT
                and (key == "moe" or rec["forward_rel_l2"] <= UNET_REL_L2)):
            fail(f"the {key} forward on the card: {rec}, launches {fwd_launches}")

        def readings(a, b) -> dict:
            flat = torch.cat([a["grads"][k].flatten() for k in a["grads"]])
            ref = torch.cat([b["grads"][k].flatten() for k in a["grads"]])
            return {"loss_rel_err": float(abs(a["loss"] - b["loss"]) / abs(b["loss"])),
                    "grad_rel_l2": rel_l2(flat, ref)}

        inputs = (x0, t, x1)
        ref = _flow_loss_and_grads(torch, ref_lit, weights, torch.device("cpu"), inputs)
        bf16 = _flow_loss_and_grads(torch, bf16_lit, weights, dev, inputs)
        reset_counts(ops)
        f32 = _flow_loss_and_grads(torch, ref_lit, weights, dev, inputs)
        torch.cuda.synchronize()
        f32_launches = {"bf16": counts(ops), "wide": wide_counts()}
        same_routing = all(torch.equal(a, b) for a, b in zip(f32["f_e"], ref["f_e"]))
        rec.update({"bf16": readings(bf16, ref), "f32": readings(f32, ref),
                    "f32_launches": f32_launches, "f32_routing_equal": same_routing,
                    "f_e_cpu": [v.tolist() for v in ref["f_e"]]})
        print(f"LitFlow({key}) loss + gradient at batch {BATCH}, card vs f32 CPU: f32 "
              f"{rec['f32']} (<= {F32_REL_L2}), launches {f32_launches}; bf16 control "
              f"{rec['bf16']}; f32 round-1 routed fractions equal the CPU's: {same_routing}",
              flush=True)
        if f32_launches["bf16"] != none or f32_launches["wide"] != wide_expected(
                "f32", PER_FORWARD_DIT):
            fail(f"the f32 {key} step launched {f32_launches}")
        if not all(v <= F32_REL_L2 for v in rec["f32"].values()):
            fail(f"the f32 LitFlow({key}) harness disagrees with the f32 CPU reference")
        if not rec["bf16"]["grad_rel_l2"] > F32_REL_L2:
            fail(f"the {key} comparison does not tell bf16 compute from f32")
        out[key] = rec
        del lits, ref, bf16, f32, ref_lit, bf16_lit
        torch.cuda.empty_cache()
    return out


def moe_dispatch_ms(torch, lit, dev, batch: int = TRAIN_BATCH) -> dict:
    """The dense one-hot dispatch of one MoE block at ``batch`` in its compute
    dtype, timed alone: the combine tensor's construction from the two
    rounds' choices and gates (``MoEMlp.combine_weights``), and the dispatch
    and combine einsums forward and backward (JAX's form, no Pallas kernel),
    at the shapes of the config's MoE blocks (s = batch · tokens an image)."""
    moe = next(m for m in lit.model.modules() if type(m).__name__ == "MoEMlp")
    d, e, dtype = moe.w_in.shape[1], moe.num_experts, moe.dtype
    s = batch * (32 // lit.model.patch_size) ** 2
    c = moe.capacity(s)
    g = torch.Generator(device=dev).manual_seed(SEED)
    logits = torch.randn((s, e), generator=g, device=dev)
    probs, masks, gates, _ = moe.route(logits, True)
    xs = torch.randn((s, d), generator=g, device=dev).to(dtype).requires_grad_(True)
    out = torch.randn((e, c, d), generator=g, device=dev).to(dtype).requires_grad_(True)
    gates = [x.detach().requires_grad_(True) for x in gates]

    def build():
        return moe.combine_weights(masks, gates, c)

    def fwd_bwd():
        combine = build()
        dispatch = (combine > 0.0).to(dtype)
        ein = torch.einsum("sec,sd->ecd", dispatch, xs)
        y = torch.einsum("sec,ecd->sd", combine.to(dtype), out + ein)
        torch.autograd.grad(y.float().sum(), [xs, out, *gates])

    with torch.no_grad():
        build_ms = device_ms(torch, build, reps=10)
    rec = {"tokens": s, "capacity": c, "combine_build_ms": build_ms,
           "einsums_fwd_bwd_ms": device_ms(torch, fwd_bwd, reps=10) - build_ms,
           "flop_einsums_fwd": 2 * 2 * s * e * c * d}
    return rec


def dit_cli(torch, np, ops, dev, card: str) -> dict:
    """Phase 37: ``trainer.main fit`` of configs/flow/cifar10_dit.yaml (DiT-S/4,
    bf16, batch 128, synthetic CIFAR-10) for 5 steps with a checkpoint, a
    resume to 10 against an uninterrupted 10-step run, bit for bit
    (deterministic cuDNN), and of cifar10_dit_moe.yaml for 10 steps (K3 12
    launches a step, nothing else); the router losses that entered one MoE
    training loss and round 1's routed fractions f_e; each saved state's
    train step timed (10 steps: median, device busy, operations, idle
    share, peak memory) under the library's default cuDNN settings; and the
    MoE blocks' dense dispatch timed alone (:func:`moe_dispatch_ms`)."""
    import shutil

    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.parallel import make_train_step
    from dmme_tpu_torch.training import CheckpointManager

    torch.backends.cudnn.deterministic = True
    roots = {k: os.path.join("build", k) for k in ("cli_dit", "cli_dit_whole", "cli_moe")}
    for root in roots.values():
        shutil.rmtree(root, ignore_errors=True)
    common = ["--data.init_args.synthetic", "true", "--data.init_args.synthetic_size", "1024",
              "--trainer.ckpt_every_n_steps", str(DIT_FIT_HALF), "--trainer.log_every_n_steps",
              "1", "--trainer.callbacks", "[]"]

    def run(path, name, root, max_steps, n_steps, *extra):
        return cli_run(torch, ops, card, name,
                       ["fit", "--config", path, *common, "--trainer.max_steps", str(max_steps),
                        "--trainer.default_root_dir", root, *extra],
                       launches_for(PER_FORWARD_DIT, n_steps))

    out = {"fit": run(DIT_CONFIG, f"dit fit {DIT_FIT_HALF}", roots["cli_dit"], DIT_FIT_HALF,
                      DIT_FIT_HALF)}
    out["resume"] = run(DIT_CONFIG, f"dit resume {DIT_FIT_HALF} -> {DIT_FIT_STEPS}",
                        roots["cli_dit"], DIT_FIT_STEPS, DIT_FIT_STEPS - DIT_FIT_HALF,
                        "--trainer.resume", "true")
    out["whole"] = run(DIT_CONFIG, f"dit uninterrupted {DIT_FIT_STEPS}", roots["cli_dit_whole"],
                       DIT_FIT_STEPS, DIT_FIT_STEPS)
    out["moe_fit"] = run(MOE_CONFIG, f"moe fit {DIT_FIT_STEPS}", roots["cli_moe"], DIT_FIT_STEPS,
                         DIT_FIT_STEPS)
    for key, root in (("whole", roots["cli_dit_whole"]), ("moe_fit", roots["cli_moe"])):
        logged = _jsonl(os.path.join(root, "metrics.jsonl"))
        out[key]["losses"] = [r["loss"] for r in logged]
        out[key]["checkpoints"] = CheckpointManager(root).steps()
        print(f"{key}: checkpoints {out[key]['checkpoints']}, losses "
              f"{[round(v, 4) for v in out[key]['losses']]}", flush=True)
        if (out[key]["checkpoints"] != [DIT_FIT_HALF, DIT_FIT_STEPS]
                or len(logged) != DIT_FIT_STEPS or not np.isfinite(out[key]["losses"]).all()):
            fail(f"the DiT CLI {key} left {out[key]}")
    a = CheckpointManager(roots["cli_dit"]).load(DIT_FIT_STEPS)
    b = CheckpointManager(roots["cli_dit_whole"]).load(DIT_FIT_STEPS)
    differ = state_differences(torch, a, b)
    out["resume_bitwise"] = {"differing_tensors": len(differ), "first": differ[:8]}
    print(f"dit resumed vs uninterrupted at step {DIT_FIT_STEPS}: {len(differ)} of "
          f"{4 * len(a['params'])} tensors differ {differ[:8]}", flush=True)
    if differ or a["step"] != b["step"]:
        fail(f"the resumed DiT run is not bitwise the uninterrupted one: {differ[:8]}")
    del a, b

    torch.backends.cudnn.deterministic = False
    for key, path, root in (("dit", DIT_CONFIG, roots["cli_dit"]),
                            ("moe", MOE_CONFIG, roots["cli_moe"])):
        lit = tcfg.instantiate(tcfg.validate_config(tcfg.load_config(path))["model"])
        state = CheckpointManager(root).restore(lit.init_state(0, device=dev))
        dm = CIFAR10(synthetic=True, synthetic_size=4 * TRAIN_BATCH, batch_size=TRAIN_BATCH)
        dm.setup("fit")
        it = dm.train_iter(SEED + 13)

        def batch(it=it):
            return torch.from_numpy(next(it)).pin_memory().to(dev, non_blocking=True)

        loss_fn = lit.make_loss_fn(dm)
        n_moe = sum(type(m).__name__ == "MoEMlp" for m in lit.model.modules())
        if key == "moe":
            # the router losses that entered one training loss, and f_e
            seen = {}
            add, model_fn = lit.add_moe_aux, lit.model_fn

            def spy_add(loss, box):
                seen["loss"], seen["box"] = loss.detach(), [(float(a), float(z)) for a, z in box]
                return add(loss, box)

            def spy_fn(p, x, t, **kw):
                y = model_fn(p, x, t, **kw)
                seen["stats"] = kw.get("moe_losses")
                return y

            lit.add_moe_aux, lit.model_fn = spy_add, spy_fn
            try:
                with torch.no_grad():
                    total = loss_fn(state.params, torch.Generator(device=dev).manual_seed(SEED),
                                    batch())
            finally:
                del lit.add_moe_aux, lit.model_fn
            stats = seen["stats"]
            aux = sum(a for a, _ in seen["box"])
            z = sum(z_ for _, z_ in seen["box"])
            router = {"base_loss": float(seen["loss"]), "total_loss": float(total),
                      "aux_sum": aux, "z_sum": z,
                      "added": float(total) - float(seen["loss"]),
                      "expected_added": lit.moe_aux_weight * aux + lit.moe_z_weight * z,
                      "per_block": [{k: (v.tolist() if k == "f_e" else float(v))
                                     for k, v in s.items()} for s in stats]}
            out["router"] = router
            print(f"MoE router losses in one training loss at step {state.step}: the "
                  f"flow loss {router['base_loss']:.6f}, Σ(aux + align) {aux:.6f} at weight "
                  f"{lit.moe_aux_weight}, Σz {z:.6f} at weight {lit.moe_z_weight}: total "
                  f"{router['total_loss']:.6f} (added {router['added']:.6f}, expected "
                  f"{router['expected_added']:.6f})", flush=True)
            for i, s in enumerate(router["per_block"]):
                print(f"  MoE block {i + 1} of {n_moe}: aux {s['moe_aux']:.4f} align "
                      f"{s['moe_align']:.4f} z {s['moe_z']:.4f} f_e "
                      f"{[round(v, 4) for v in s['f_e']]}", flush=True)
            if (len(stats) != n_moe or abs(router["added"] - router["expected_added"])
                    > 1e-5 * max(1.0, abs(router["total_loss"]))
                    or not all(abs(sum(s["f_e"]) - 1.0) < 1e-5 for s in router["per_block"])):
                fail(f"the MoE router losses did not enter the loss as JAX adds them: {router}")
        step = make_train_step(loss_fn)
        state, _ = step(state, batch(), SEED)  # first launches of this step object
        print(f"-- {key}: the saved state's train step at batch {TRAIN_BATCH}", flush=True)
        _, out[f"{key}_timing"], out[f"{key}_profile_3_steps"], out[f"{key}_profile_1_step"] = (
            timed_steps(torch, np, step, state, batch, card))
        if key == "moe":
            rec = moe_dispatch_ms(torch, lit, dev)
            per_step = n_moe * (rec["combine_build_ms"] + rec["einsums_fwd_bwd_ms"])
            rec["per_step_ms"] = per_step
            rec["share_of_busy"] = per_step / (out["moe_profile_3_steps"]["busy_ms"] / 3)
            rec["share_of_median"] = per_step / out["moe_timing"]["step_ms_median"]
            out["dispatch"] = rec
            print(f"MoE dense dispatch at batch {TRAIN_BATCH} ({rec['tokens']} tokens, capacity "
                  f"{rec['capacity']}): combine built in {rec['combine_build_ms']:.4f} ms, "
                  f"dispatch and combine einsums forward + backward "
                  f"{rec['einsums_fwd_bwd_ms']:.4f} ms a block; {n_moe} blocks {per_step:.3f} ms a "
                  f"step, {rec['share_of_busy']:.3f} of its device busy, "
                  f"{rec['share_of_median']:.3f} of its median [{card}]", flush=True)
        del state, lit, step, loss_fn
        torch.cuda.empty_cache()
    for root in roots.values():
        shutil.rmtree(root, ignore_errors=True)
    return out


def dit_serve(torch, np, blocks, dev, ops, card: str) -> dict:
    """Phase 38: the DiT and MoE-DiT flow harnesses served. ``LitFlow`` of
    each config (bf16, random weights) behind ``make_server``: ``default``
    (25 midpoint steps, 50 evaluations) at n = 8 and ``flow`` at 10 steps,
    each repeated for identical bytes, launches 12 K3 a forward and nothing
    else; the discrete-schedule samplers answered 400; one n = 8 ``default``
    request under the profiler."""
    from dmme_tpu_torch.serving import Sampler
    from dmme_tpu_torch.training import TrainState

    out = {}
    for key, path in (("dit", DIT_CONFIG), ("moe", MOE_CONFIG)):
        lit, weights = dit_harness(torch, blocks, path)
        state = TrainState.create(weights, lit.make_optimizer())
        sampler = Sampler(lit, state, img_size=32, device=dev)
        url, stop = _serve(torch, sampler)
        rec = {}
        try:
            rec["requests"] = solver_requests(np, url, ops, key, card, [
                ("default", None, launches_for(PER_FORWARD_DIT, FLOW_NFE)),
                ("flow", 10, launches_for(PER_FORWARD_DIT, 2 * 10))])
            rec["launches"] = rec["requests"][0]["launches"]
            rec["rejected"] = {"cached": rejected(url, key, "cached", "discrete-schedule")}
        finally:
            stop()
        prof = profile_fn(torch, lambda: sampler.sample(BATCH, seed=5))
        rec["profile_n8"] = prof
        print(f"{key} default n=8 under torch.profiler: wall {prof['wall_ms']:.2f} ms, device "
              f"busy {prof['busy_ms']:.2f} ms in {prof['device_ops']} operations, idle share "
              f"{prof['idle_share']:.3f} [{card}]", flush=True)
        for name, ms, count in prof["top"]:
            print(f"    {ms:9.3f} ms {count:6d}x  {name}", flush=True)
        out[key] = rec
        del sampler, state, lit, weights
        torch.cuda.empty_cache()
    return out


def distill_kernels(torch, np, blocks, k_gn, k_attn, k_res, build, dev, ops, card: str) -> dict:
    """Phase 39a: every kernel call of one progressive-distillation step at
    batch 128 of the DDPM UNet of configs/ddpm/cifar10.yaml (bf16, random
    weights): the ε teacher's two forwards under ``no_grad`` (K4 at N = 128,
    22 sites each, K3 6 and K1 at ``out_norm``) and the v student's
    training forward and backward (K1 45, K2 45, K3 6 and the attention
    backward), launches 47/45/18/44; each call held against its plain
    version (``TOL``, ``TOL_BWD``) and timed; then the step timed (10 steps:
    median, device busy, operations, idle share, peak memory)."""
    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.diffusion import ProgressiveDistillation
    from dmme_tpu_torch.models import init_weights
    from dmme_tpu_torch.parallel import make_train_step
    from dmme_tpu_torch.training import LitDDPM, LitDistill

    teacher = LitDDPM(dtype="bf16")
    init_weights(teacher.model, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, teacher.model, torch.Generator().manual_seed(SEED + 1))
    tparams = {k: v.detach().clone().to(dev) for k, v in teacher.model.state_dict().items()}
    lit = LitDistill(teacher_model=teacher.model.to(dev), teacher_params=tparams,
                     distiller=ProgressiveDistillation.create(
                         1000, DISTILL_START, teacher_parameterization="eps"),
                     decay=0.999)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in tparams.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = torch.randint(0, 256, (TRAIN_BATCH, 32, 32, 3), generator=gen, device=dev,
                          dtype=torch.uint8)
    dm = CIFAR10(batch_size=TRAIN_BATCH)
    loss_fn = lit.make_loss_fn(dm)

    def step():
        loss = loss_fn(params, gen, batch)
        torch.autograd.grad(loss, list(params.values()))

    targets = train_targets(blocks, k_gn, k_attn) + [
        (blocks, "resblock_forward", "resblock", _sig_res)]
    reset_counts(ops)
    calls = record_calls(targets, step)
    torch.cuda.synchronize()
    launches = counts(ops)
    expect_bf16_only("distillation step")
    sites = {k: sum(c for _, c, _, _ in v) for k, v in calls.items()}
    want_sites = dict(PER_DISTILL_STEP, attention_bwd=6)
    print(f"distillation step at batch {TRAIN_BATCH}: call sites {sites}, launches {launches} "
          f"(expected {PER_DISTILL_STEP})", flush=True)
    if sites != want_sites or launches != PER_DISTILL_STEP:
        fail(f"the distillation step has call sites {sites} and launches {launches}")
    k4 = {"resblock": {key: {"a": a, "k": k, "sites": {"distill": count}}
                       for key, count, a, k in calls.pop("resblock")}}
    rows, per_step = step_rows(torch, k_gn, k_attn, calls, card,
                               f"per distillation step (batch {TRAIN_BATCH})")
    k4_rows, failures = forward_rows(torch, k_gn, k_attn, k_res, build, dev, k4)
    if failures:
        fail(f"the teacher's K4 calls disagree with their plain versions: {failures}")
    per_step["resblock"] = _per_forward(k4_rows, "distill", card,
                                        f"distillation step (the teacher's 2 forwards at "
                                        f"N = {TRAIN_BATCH})", ("resblock",))["resblock"]
    out = {"rows": rows + k4_rows, "per_step": per_step, "launches": launches}
    del params, calls, k4
    torch.cuda.empty_cache()

    state = lit.init_state(0, device=dev)
    sdm = CIFAR10(synthetic=True, synthetic_size=4 * TRAIN_BATCH, batch_size=TRAIN_BATCH)
    sdm.setup("fit")
    it = sdm.train_iter(SEED + 17)

    def batch_fn():
        return torch.from_numpy(next(it)).pin_memory().to(dev, non_blocking=True)

    tstep = make_train_step(lit.make_loss_fn(sdm))
    state, _ = tstep(state, batch_fn(), SEED)
    print(f"-- the distillation train step at batch {TRAIN_BATCH}", flush=True)
    _, out["timing"], out["profile_3_steps"], out["profile_1_step"] = timed_steps(
        torch, np, tstep, state, batch_fn, card)
    del state, lit, teacher, tparams, tstep
    k_res._PACKED.clear()
    torch.cuda.empty_cache()
    return out


def distill_driver(torch, np, ops, dev, card: str) -> dict:
    """Phase 39b: ``python -m dmme_tpu_torch.distill`` in this process on a
    temporary copy of configs/ddpm/cifar10.yaml (synthetic CIFAR-10, its
    ``default_root_dir`` under build/): ``trainer.main fit`` writes the ε
    teacher's checkpoint (2 steps), then the driver restores it and runs
    ``DISTILL_ROUNDS`` rounds of ``DISTILL_STEPS`` steps (100 then 50
    student steps; the first student a v model from scratch, the second
    from the first's EMA), launches ``PER_DISTILL_STEP`` a step, a
    checkpoint a round; then the last student's DDIM-50 request at n = 8
    (launches 1/6/22 a forward, finite, repeatable)."""
    import contextlib
    import shutil

    import yaml

    from dmme_tpu_torch import distill
    from dmme_tpu_torch.diffusion import ProgressiveDistillation
    from dmme_tpu_torch.training import CheckpointManager, LitDDPM, LitDistill

    torch.backends.cudnn.deterministic = True
    root = os.path.join("build", "distill")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    with open("configs/ddpm/cifar10.yaml") as f:
        config = yaml.safe_load(f)
    config["trainer"].update(default_root_dir=os.path.join(root, "teacher"),
                             log_every_n_steps=1, callbacks=[])
    config["data"]["init_args"].update(synthetic=True, synthetic_size=1024)
    path = os.path.join(root, "cifar10.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    out = {"teacher_fit": cli_run(torch, ops, card, "teacher fit 2",
                                  ["fit", "--config", path, "--trainer.max_steps", "2"],
                                  {k: 2 * v for k, v in PER_TRAIN_STEP.items()})}

    reset_counts(ops)
    log = io.StringIO()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.time()
    with contextlib.redirect_stdout(log):
        rounds = distill.main(["--config", path, "--start-steps", str(DISTILL_START),
                               "--rounds", str(DISTILL_ROUNDS), "--steps-per-round",
                               str(DISTILL_STEPS), "--out", os.path.join(root, "out")])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = counts(ops)
    expect_bf16_only("distillation driver")
    print(log.getvalue().rstrip(), flush=True)
    want = {k: v * DISTILL_STEPS * DISTILL_ROUNDS for k, v in PER_DISTILL_STEP.items()}
    mem1 = torch.cuda.memory_allocated()
    out["driver"] = {"wall_s": wall, "launches": launches, "rounds": rounds,
                     "checkpoints": [CheckpointManager(d).steps() for _, d in rounds],
                     "memory_allocated_before_gib": mem0 / 2**30,
                     "memory_allocated_after_gib": mem1 / 2**30}
    print(f"distillation driver: {DISTILL_ROUNDS} rounds {rounds} of {DISTILL_STEPS} steps in "
          f"{wall:.2f} s wall, launches {launches} (expected {want}), checkpoints "
          f"{out['driver']['checkpoints']}; allocated {mem0 / 2**30:.3f} GiB before, "
          f"{mem1 / 2**30:.3f} GiB after [{card}]", flush=True)
    restored = "# teacher restored from" in log.getvalue()
    # nothing of the rounds stays allocated once the driver returns: not the
    # teachers' weights through K4's packed-weight cache (fault C.10)
    if (launches != want or not restored or mem1 - mem0 > DRIVER_LEFT_BYTES
            or [s for s, _ in rounds] != [DISTILL_START // 2 ** k for k in range(DISTILL_ROUNDS)]
            or out["driver"]["checkpoints"] != [[DISTILL_STEPS]] * DISTILL_ROUNDS):
        fail(f"the distillation driver: {out['driver']}, teacher restored {restored}")

    steps, last = rounds[-1]
    student = LitDDPM(dtype="bf16").model
    lit = LitDistill(teacher_model=student, teacher_params={},
                     distiller=ProgressiveDistillation.create(1000, steps))
    state = CheckpointManager(last).restore(lit.init_state(0, device=dev))

    def request(seed):
        x = lit.generate(state, torch.Generator(device=dev).manual_seed(seed),
                         (BATCH, 32, 32, 3))
        torch.cuda.synchronize()
        return x

    reset_counts(ops)
    t0 = time.perf_counter()
    a = request(3)
    secs = time.perf_counter() - t0
    student_launches = counts(ops)
    b = request(3)
    want = launches_for(PER_FORWARD, steps)
    out["student_request"] = {"steps": steps, "s": secs, "launches": student_launches,
                              "finite": bool(a.isfinite().all()),
                              "identical": bool(torch.equal(a, b)), "std": float(a.std())}
    print(f"student DDIM-{steps} at n = {BATCH}: {secs:.3f} s, launches {student_launches} "
          f"(expected {want}), finite {out['student_request']['finite']}, repeat "
          f"{'identical' if out['student_request']['identical'] else 'DIFFERENT'} [{card}]",
          flush=True)
    if (student_launches != want or not out["student_request"]["finite"]
            or not out["student_request"]["identical"]):
        fail(f"the student request: {out['student_request']}")
    del lit, state, student
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def inpaint_phase(torch, np, blocks, dev, ops, card: str) -> dict:
    """Phase 40: RePaint inpainting with ``LitDDPM(dtype="bf16",
    timesteps=INPAINT_T)``'s DDPM (T = 100) and UNet (random weights) at
    n = 8: the left half of numpy images known, ``INPAINT_RESAMPLE``
    repeats a step (200 forwards, launches 1/6/22 each); the known pixels
    must come back bit for bit, the
    generated half differ from the known images, everything finite."""
    from dmme_tpu_torch.diffusion import inpaint
    from dmme_tpu_torch.models import init_weights
    from dmme_tpu_torch.training import LitDDPM

    torch.backends.cudnn.deterministic = True
    lit = LitDDPM(dtype="bf16", timesteps=INPAINT_T)
    init_weights(lit.model, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, lit.model, torch.Generator().manual_seed(SEED + 1))
    lit.model.to(dev).eval()
    params = {k: v.detach() for k, v in lit.model.state_dict().items()}
    r = np.random.default_rng(SEED + 220)
    known = torch.tensor(np.clip(r.standard_normal((BATCH, 32, 32, 3)) / 2, -1, 1)
                         .astype(np.float32)).to(dev)
    mask = torch.zeros((1, 32, 32, 1), device=dev)
    mask[:, :, :16] = 1.0
    reset_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = inpaint(lit.diffusion_model, lit.model_fn, params,
                torch.Generator(device=dev).manual_seed(SEED), known, mask,
                resample_steps=INPAINT_RESAMPLE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = counts(ops)
    expect_bf16_only("inpainting")
    forwards = lit.diffusion_model.timesteps * INPAINT_RESAMPLE
    want = launches_for(PER_FORWARD, forwards)
    exact = bool(torch.equal(x[:, :, :16], known[:, :, :16]))
    generated = float((x[:, :, 16:] - known[:, :, 16:]).abs().max())
    out = {"s": secs, "forwards": forwards, "launches": launches, "known_exact": exact,
           "generated_max_abs_diff": generated, "finite": bool(x.isfinite().all()),
           "std": float(x.std())}
    print(f"inpaint T = {lit.diffusion_model.timesteps}, resample_steps {INPAINT_RESAMPLE}, "
          f"n = {BATCH}: {secs:.3f} s ({forwards} forwards), launches {launches} (expected "
          f"{want}); known half bit for bit: {exact}; generated half max |x − known| "
          f"{generated:.4f}, finite {out['finite']} [{card}]", flush=True)
    if launches != want or not (exact and out["finite"] and generated > 0.05):
        fail(f"inpainting: {out}")
    del lit, params
    torch.cuda.empty_cache()
    return out


# latent diffusion (A.8): the codec of configs/latent/shapes_vae_demo.yaml
# (factor 2: 32-px images to 16x16x4 latents, 1,542,219 parameters) and the
# two stage-2 configs that read its run directory
LATENT_VAE_CONFIG = "configs/latent/shapes_vae_demo.yaml"
LATENT_DDPM_CONFIG = "configs/latent/shapes_latent_demo.yaml"
LATENT_DIT_CONFIG = "configs/latent/shapes_latent_flow_dit_demo.yaml"
LATENT_CODEC = dict(latent_channels=4, base_channels=64, channel_multipliers=(1, 2),
                    num_res_blocks=2)
VAE_PARAMS = 1_542_219
LATENT = (16, 16, 4)
LATENT_SCALE = 1.0  # an explicit latent scale where no calibration is under test
NO_LAUNCHES = {"group_norm_silu": 0, "group_norm_silu_bwd": 0, "attention": 0, "resblock": 0}
# the stage-2 config's UNet (128/256/256, attention at depth 2, no kernel
# switches): K3 alone, at 6 sites a forward (T = 64 five times, T = 16 once)
PER_FORWARD_LATENT_CFG = dict(NO_LAUNCHES, attention=6)
# the latent DiT (hidden 256, depth 8, 4 heads of 64 at T = 64)
LATENT_DIT_SITES = 8
PER_FORWARD_LATENT_DIT = dict(NO_LAUNCHES, attention=LATENT_DIT_SITES)
# the latent CLI fits: steps before the resume, and in all, in chunks of 5
# steps (the configs' 10, cut: a log line a chunk); the Shapes images
# rendered for them; the steps of the stage-2 config's own (ancestral)
# sampler in `sample` (the config trains T = 1000)
LATENT_FIT_HALF, LATENT_FIT_STEPS, LATENT_CHUNK = 5, 10, 5
LATENT_DATA = SHAPES_CUT
LATENT_SAMPLE_T = 50


def latent_codec(torch, blocks, dtype: str = "bf16", codec: dict = None):
    """The configs' ConvVAE (or ``codec``'s widths; {} for the defaults) in
    ``dtype``: flax's init from the seed with every bias and GroupNorm affine
    drawn. Returns (module, its f32 weights)."""
    from dmme_tpu_torch.models import init_weights
    from dmme_tpu_torch.models.vae import ConvVAE
    from dmme_tpu_torch.training.lit import resolve_dtype

    vae = ConvVAE(**(LATENT_CODEC if codec is None else codec), dtype=resolve_dtype(dtype))
    init_weights(vae, torch.Generator().manual_seed(SEED + 300))
    randomize_affines(torch, blocks, vae, torch.Generator().manual_seed(SEED + 301))
    return vae, {k: v.detach().clone() for k, v in vae.state_dict().items()}


def latent_harness(torch, blocks, dtype: str = "bf16", model=None, flow: bool = False,
                   codec: dict = None):
    """``LitLatentDDPM`` (``LitLatentFlow`` with ``flow``) in ``dtype`` over
    :func:`latent_codec` at ``LATENT_SCALE``, its denoiser the default latent
    UNet (both switches) or ``model``, every weight random. Returns
    (harness, the denoiser's weights)."""
    from dmme_tpu_torch.models import init_weights
    from dmme_tpu_torch.training import LitLatentDDPM, LitLatentFlow

    vae, weights = latent_codec(torch, blocks, dtype, codec)
    lit = (LitLatentFlow if flow else LitLatentDDPM)(
        vae=vae, vae_params=weights, latent_scale=LATENT_SCALE, dtype=dtype, model=model)
    init_weights(lit.model, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, lit.model, torch.Generator().manual_seed(SEED + 1))
    return lit, {k: v.detach().clone() for k, v in lit.model.state_dict().items()}


def latent_config_model(torch, path: str, dtype: str = "bf16"):
    """The denoiser a stage-2 config names, in ``dtype``."""
    from dmme_tpu_torch import config as tcfg

    node = tcfg.load_config(path)["model"]["init_args"]["model"]
    return tcfg.instantiate(dict(node, init_args=dict(node["init_args"], dtype=dtype)))


def latent_kernels(torch, np, blocks, k_gn, k_attn, k_res, build, dev, ops, card: str) -> dict:
    """Phase 41: the latent call sites. The default latent UNet (bf16, both
    switches, random weights) on 16x16x4 latents: every K1, K3 and K4 call
    of forwards at n = 1, 8, 16 (1/6/22 launches a forward; K4 and K1 at
    2x2, K3 at T = 4 and 64), and every K1, K2, K3 and attention-backward
    call of one ``LitLatentDDPM`` step at batch 128 (the bf16 codec encodes
    the 32-px batch first, on library ops: 45/45/6/0); the stage-2 config
    UNet's K3 at a step at batch 128 (6 sites); the latent DiT's K3 at a
    forward at n = 8 and a ``LitLatentFlow`` step at batch 128 (8 sites,
    4 heads of 64 at T = 64). Each held against its plain version
    (``TOL``/``TOL_BWD``), twice for identical bytes, and timed; no f32,
    fp16 or ``simt.cu`` counter moves."""
    from dmme_tpu_torch.models import init_weights

    out = {"forward_rows": [], "per_forward": {}}
    lit, _ = latent_harness(torch, blocks)
    model = lit.model.to(dev).eval()
    runs = {}
    for n in SERVE_BATCHES:
        g = torch.Generator().manual_seed(SEED + 310 + n)
        runs[f"latent_n{n}"] = (model, torch.randn((n, *LATENT), generator=g),
                                torch.randint(1, 1000, (n,), generator=g), PER_FORWARD)
    reset_counts(ops)
    recorded, _ = record_forwards(torch, blocks, runs, dev)
    torch.cuda.synchronize()
    launches = counts(ops)
    expect_bf16_only("latent UNet forwards")
    want = launches_for(PER_FORWARD, len(SERVE_BATCHES))
    bottom = sorted({e["a"][0].shape[1] for e in recorded["resblock"].values()})
    tokens = sorted({e["a"][0].shape[1] for e in recorded["attention"].values()})
    print(f"latent UNet forwards at n = {SERVE_BATCHES}: launches {launches} (expected {want}); "
          f"ResBlock sides {bottom}, attention tokens {tokens}", flush=True)
    if launches != want or bottom[0] != 2 or tokens[0] != 4:
        fail(f"the latent forwards launched {launches} at sides {bottom}, tokens {tokens}")
    rows, failures = forward_rows(torch, k_gn, k_attn, k_res, build, dev, recorded)
    if failures:
        fail(f"latent forward kernels disagree with their plain versions: {failures}")
    out["forward_rows"] += rows
    out["per_forward"]["latent"] = _per_forward(rows, f"latent_n{BATCH}", card,
                                                f"latent UNet forward, n = {BATCH}")
    del lit, model, runs, recorded
    torch.cuda.empty_cache()

    print(f"-- LitLatentDDPM (default latent UNet) training step at batch {TRAIN_BATCH}",
          flush=True)
    out["train"] = train_kernels(torch, blocks, k_gn, k_attn, None, init_weights, None, dev,
                                 card, ops, lit=latent_harness(torch, blocks)[0])
    torch.cuda.empty_cache()
    k3 = [(blocks, "attention_heads", "attention", _sig_attn),
          (k_attn, "attention_bwd", "attention_bwd", _sig_attn)]
    print(f"-- LitLatentDDPM ({LATENT_DDPM_CONFIG}'s UNet) training step at batch {TRAIN_BATCH}",
          flush=True)
    out["cfg_train"] = train_kernels(
        torch, blocks, k_gn, k_attn, None, init_weights, None, dev, card, ops,
        lit=latent_harness(torch, blocks, model=latent_config_model(torch,
                                                                    LATENT_DDPM_CONFIG))[0],
        targets=k3, sites={"attention": 6, "attention_bwd": 6})
    torch.cuda.empty_cache()

    lit, _ = latent_harness(torch, blocks, model=latent_config_model(torch, LATENT_DIT_CONFIG),
                            flow=True)
    g = torch.Generator().manual_seed(SEED + 320)
    name = f"latent_dit_n{BATCH}"
    runs = {name: (lit.model.to(dev).eval(), torch.randn((BATCH, *LATENT), generator=g),
                   1000.0 * torch.rand((BATCH,), generator=g), {"attention": LATENT_DIT_SITES})}
    reset_counts(ops)
    recorded, _ = record_forwards(torch, blocks, runs, dev, dit_targets(k_attn, False))
    torch.cuda.synchronize()
    launches = counts(ops)
    expect_bf16_only("latent DiT forward")
    if launches != PER_FORWARD_LATENT_DIT:
        fail(f"the latent DiT forward launched {launches}, expected {PER_FORWARD_LATENT_DIT}")
    rows, failures = forward_rows(torch, k_gn, k_attn, k_res, build, dev, recorded)
    if failures:
        fail(f"latent DiT kernels disagree with their plain versions: {failures}")
    out["forward_rows"] += rows
    out["per_forward"]["dit"] = _per_forward(rows, name, card, f"latent DiT forward, {name}",
                                             ("attention",))
    del lit, runs, recorded
    torch.cuda.empty_cache()
    print(f"-- LitLatentFlow ({LATENT_DIT_CONFIG}'s DiT) training step at batch {TRAIN_BATCH}",
          flush=True)
    out["dit_train"] = train_kernels(
        torch, blocks, k_gn, k_attn, None, init_weights, None, dev, card, ops,
        lit=latent_harness(torch, blocks, model=latent_config_model(torch, LATENT_DIT_CONFIG),
                           flow=True)[0],
        targets=dit_targets(k_attn, True),
        sites={"attention": LATENT_DIT_SITES, "attention_bwd": LATENT_DIT_SITES})
    torch.cuda.empty_cache()
    return out


def _latent_loss_and_grads(torch, blocks, lit, weights, device, inputs, masks, replay):
    """A latent DDPM step's loss core on ``device``: the posterior sample on
    the injected noise (``encode_target``), ``loss_given`` on the injected
    t and ε with the dropout masks recorded on the card (replayed with
    ``replay``), and every denoiser gradient."""
    from dmme_tpu_torch.training.latent import LitVAE

    params = {k: v.to(device).requires_grad_(True) for k, v in weights.items()}
    x, zn, t, eps = (v.to(device) for v in inputs)
    lit.model.to(device)
    if isinstance(lit, LitVAE):  # the codec's own objective on the posterior noise
        loss = lit.loss_given(params, x, zn)
    else:
        z = lit.encode_target(None, x, noise=zn)
        undo = _dropout_masks(blocks, lit.model, masks, replay)
        try:
            loss = lit.diffusion_model.loss_given(
                lit.model_fn, params, z, t, eps, train=True,
                generator=torch.Generator(device=device).manual_seed(SEED))
        finally:
            undo()
    grads = torch.autograd.grad(loss, list(params.values()))
    return {"loss": loss.detach().cpu(),
            "grads": {k: g.detach().float().cpu() for k, g in zip(params, grads)}}


def latent_vs_cpu(torch, np, blocks, dev, ops, card: str) -> dict:
    """Phase 42: the latent paths on the card against f32 on the CPU, on the
    same random weights and numpy inputs at batch 8: the bf16 codec's
    encode (mean, logvar) and decode (``UNET_REL_L2``; library ops, no
    kernel launch); the bf16 ``LitLatentDDPM`` loss and gradient with the
    posterior noise, t, ε and dropout injected (``GRAD_REL_L2``; 45/45/6/0);
    the default f32 ``LitVAE()`` and ``LitLatentDDPM()`` loss and gradient
    within ``F32_REL_L2``, each with a bf16 control that must miss it (the
    f32 step launches K1/K2/K3 of f32 only)."""
    r = np.random.default_rng(SEED + 330)
    x = torch.tensor(np.clip(r.standard_normal((BATCH, 32, 32, 3)) / 2, -1, 1).astype(np.float32))
    zn = torch.tensor(r.standard_normal((BATCH, *LATENT)).astype(np.float32))
    t = torch.tensor(r.integers(1, 1000, (BATCH,)), dtype=torch.int64)
    eps = torch.tensor(r.standard_normal((BATCH, *LATENT)).astype(np.float32))
    inputs = (x, zn, t, eps)
    out = {}

    vae, weights = latent_codec(torch, blocks, "bf16")
    ref, _ = latent_codec(torch, blocks, "f32")
    with torch.no_grad():
        want_mean, want_logvar = ref.encode(x)
        want_rec = ref.decode(want_mean)
        vae.to(dev)
        reset_counts(ops)
        mean, logvar = vae.encode(x.to(dev))
        rec = vae.decode(want_mean.to(dev))
        torch.cuda.synchronize()
    launches = counts(ops)
    expect_bf16_only("the bf16 codec")
    codec = {"mean_rel_l2": rel_l2(mean.cpu(), want_mean),
             "logvar_rel_l2": rel_l2(logvar.cpu(), want_logvar),
             "decode_rel_l2": rel_l2(rec.cpu(), want_rec), "launches": launches,
             "dtypes": [str(v.dtype) for v in (mean, logvar, rec)]}
    out["codec"] = codec
    print(f"bf16 ConvVAE at n = {BATCH} vs f32 CPU: {codec} (<= {UNET_REL_L2})", flush=True)
    if (launches != NO_LAUNCHES or codec["dtypes"] != ["torch.float32"] * 3
            or not all(codec[k] <= UNET_REL_L2 for k in ("mean_rel_l2", "logvar_rel_l2",
                                                          "decode_rel_l2"))):
        fail(f"the bf16 codec on the card: {codec}")
    del vae, ref

    def readings(a, b) -> dict:
        flat = torch.cat([a["grads"][k].flatten() for k in a["grads"]])
        ref_ = torch.cat([b["grads"][k].flatten() for k in a["grads"]])
        return {"loss_rel_err": float(abs(a["loss"] - b["loss"]) / abs(b["loss"])),
                "grad_rel_l2": rel_l2(flat, ref_)}

    lits = {d: latent_harness(torch, blocks, d) for d in ("bf16", "f32")}
    weights = lits["f32"][1]
    masks = {}
    reset_counts(ops)
    bf16 = _latent_loss_and_grads(torch, blocks, lits["bf16"][0], weights, dev, inputs, masks,
                                  False)
    torch.cuda.synchronize()
    bf16_launches = counts(ops)
    expect_bf16_only("latent DDPM step vs the CPU")
    ref = _latent_loss_and_grads(torch, blocks, lits["f32"][0], weights, torch.device("cpu"),
                                 inputs, masks, True)
    out["bf16"] = dict(readings(bf16, ref), launches=bf16_launches, masks=len(masks))
    print(f"LitLatentDDPM bf16 loss + gradient at batch {BATCH} vs f32 CPU: {out['bf16']} "
          f"(<= {GRAD_REL_L2})", flush=True)
    if (bf16_launches != PER_TRAIN_STEP or out["bf16"]["grad_rel_l2"] > GRAD_REL_L2
            or out["bf16"]["loss_rel_err"] > GRAD_REL_L2):
        fail(f"the bf16 latent DDPM step on the card: {out['bf16']}")

    # the f32 defaults: LitLatentDDPM() on the card (K1/K2/K3 in f32), the
    # bf16 step above as its control
    reset_counts(ops)
    f32 = _latent_loss_and_grads(torch, blocks, lits["f32"][0], weights, dev, inputs, masks, True)
    torch.cuda.synchronize()
    f32_launches = {"bf16": counts(ops), "wide": wide_counts()}
    out["f32"] = dict(readings(f32, ref), launches=f32_launches)
    out["f32_control_bf16"] = readings(bf16, ref)
    print(f"LitLatentDDPM() f32 on the card vs the CPU: {readings(f32, ref)} (<= {F32_REL_L2}), "
          f"launches {f32_launches}; bf16 control {out['f32_control_bf16']}", flush=True)
    if (f32_launches["bf16"] != NO_LAUNCHES
            or f32_launches["wide"] != wide_expected("f32", PER_TRAIN_STEP)):
        fail(f"the f32 latent step launched {f32_launches}")
    if not all(v <= F32_REL_L2 for v in readings(f32, ref).values()):
        fail("the f32 LitLatentDDPM() disagrees with the f32 CPU reference")
    if not out["f32_control_bf16"]["grad_rel_l2"] > F32_REL_L2:
        fail("the latent comparison does not tell bf16 compute from f32")
    del lits, bf16, ref, f32
    torch.cuda.empty_cache()

    # LitVAE(): the default codec (latent 4, base 32, one block a level) in
    # f32, its bf16 twin the control
    from dmme_tpu_torch.training import LitVAE

    vaes = {d: LitVAE(model=latent_codec(torch, blocks, d, {})[0]) for d in ("bf16", "f32")}
    weights = dict(vaes["f32"].model.state_dict())
    ref = _latent_loss_and_grads(torch, blocks, vaes["f32"], weights, torch.device("cpu"),
                                 inputs, None, False)
    reset_counts(ops)
    f32 = _latent_loss_and_grads(torch, blocks, vaes["f32"], weights, dev, inputs, None, False)
    bf16 = _latent_loss_and_grads(torch, blocks, vaes["bf16"], weights, dev, inputs, None, False)
    torch.cuda.synchronize()
    launches = {"bf16": counts(ops), "wide": wide_counts()}
    out["vae_f32"], out["vae_control_bf16"] = readings(f32, ref), readings(bf16, ref)
    print(f"LitVAE() f32 loss + gradient at batch {BATCH} vs the CPU: {out['vae_f32']} "
          f"(<= {F32_REL_L2}); bf16 control {out['vae_control_bf16']}; launches {launches}",
          flush=True)
    if launches["bf16"] != NO_LAUNCHES or launches["wide"] != wide_expected("f32", NO_LAUNCHES):
        fail(f"the codec launched a kernel: {launches}")
    if not all(v <= F32_REL_L2 for v in out["vae_f32"].values()):
        fail("the f32 LitVAE() disagrees with the f32 CPU reference")
    if not out["vae_control_bf16"]["grad_rel_l2"] > F32_REL_L2:
        fail("the codec comparison does not tell bf16 compute from f32")
    return out


def latent_cli(torch, np, ops, dev, card: str) -> dict:
    """Phase 43: the two-stage recipe through ``trainer.main`` in this
    process (deterministic cuDNN): ``fit`` of configs/latent/shapes_vae_demo.yaml
    (bf16, batch 128, 10 steps in chunks of 5, checkpoints at 5 and 10; no
    kernel launch), then of shapes_latent_demo.yaml (K3 6 a step) and
    shapes_latent_flow_dit_demo.yaml (K3 8 a step) from that directory: the
    latent scale calibrated and written to ``latent_scale.json``, equal to
    the one recomputed from the same weights and data; stage 2 resumed from
    step 5 to 10, bitwise the uninterrupted run; ``sample`` with and
    without ``--trainer.sampler ddim`` (32x32x3 images), and the stage-1
    config's ``sample --trainer.sampler ddim`` refused; then 5 timed steps
    at batch 128 (median, device busy, operations, idle share, peak memory)
    of the stage-1 ``LitVAE``, of ``LitLatentDDPM(dtype="bf16")`` with its
    default UNet over the stage-1 codec (launches 45/45/6/0 a step) and of
    the DiT config's ``LitLatentFlow``, under the library's cuDNN defaults."""
    import shutil

    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.data import Shapes
    from dmme_tpu_torch.models.vae import ConvVAE
    from dmme_tpu_torch.parallel import make_train_step
    from dmme_tpu_torch.trainer import main as cli
    from dmme_tpu_torch.training import CheckpointManager, LitLatentDDPM
    from dmme_tpu_torch.training.latent import SCALE_FILENAME
    from dmme_tpu_torch.utils.vis import make_history

    torch.backends.cudnn.deterministic = True
    roots = {k: os.path.join("build", f"cli_latent_{k}") for k in ("vae", "ddpm", "whole", "dit")}
    for root in roots.values():
        shutil.rmtree(root, ignore_errors=True)
    common = [*LATENT_DATA, "--trainer.log_every_n_steps", "1", "--trainer.tensorboard", "false",
              "--trainer.ckpt_every_n_steps", str(LATENT_FIT_HALF),
              "--trainer.steps_per_call", str(LATENT_CHUNK)]
    stage2 = ["--model.init_args.vae_ckpt", roots["vae"]]

    def run(path, name, root, max_steps, n_steps, per_step, *extra):
        return cli_run(torch, ops, card, name,
                       ["fit", "--config", path, *common, "--trainer.max_steps", str(max_steps),
                        "--trainer.default_root_dir", root, *extra],
                       launches_for(per_step, n_steps))

    out = {"vae_fit": run(LATENT_VAE_CONFIG, f"stage 1 fit {LATENT_FIT_STEPS}", roots["vae"],
                          LATENT_FIT_STEPS, LATENT_FIT_STEPS, NO_LAUNCHES)}
    out["ddpm_fit"] = run(LATENT_DDPM_CONFIG, f"stage 2 DDPM fit {LATENT_FIT_HALF}",
                          roots["ddpm"], LATENT_FIT_HALF, LATENT_FIT_HALF,
                          PER_FORWARD_LATENT_CFG, *stage2)
    with open(os.path.join(roots["vae"], SCALE_FILENAME)) as f:
        saved = json.load(f)
    cfg = tcfg.validate_config(tcfg.load_config(LATENT_DDPM_CONFIG))
    probe = LitLatentDDPM(vae=ConvVAE(**LATENT_CODEC, dtype=torch.bfloat16),
                          vae_params=CheckpointManager(roots["vae"]).load()["ema_params"],
                          scale_probe_n=saved["probe_n"], dtype="bf16")
    probe.init_state(0, device=dev)  # the probe runs on the state's device, as in fit
    data = tcfg.instantiate(tcfg.apply_overrides(cfg, LATENT_DATA)["data"])
    again = probe._resolve_scale(data)
    out["scale"] = {"saved": saved, "recomputed": again, "equal": again == saved["latent_scale"]}
    print(f"latent scale written by the stage-2 fit {saved}; recomputed from the same weights "
          f"and data {again!r} (equal: {out['scale']['equal']})", flush=True)
    if abs(again - saved["latent_scale"]) > 1e-6 * abs(again) or saved["probe_n"] != 256:
        fail(f"the persisted latent scale is not the recomputed one: {out['scale']}")
    del probe, data
    out["ddpm_resume"] = run(LATENT_DDPM_CONFIG,
                             f"stage 2 DDPM resume {LATENT_FIT_HALF} -> {LATENT_FIT_STEPS}",
                             roots["ddpm"], LATENT_FIT_STEPS, LATENT_FIT_STEPS - LATENT_FIT_HALF,
                             PER_FORWARD_LATENT_CFG, *stage2, "--trainer.resume", "true")
    out["ddpm_whole"] = run(LATENT_DDPM_CONFIG, f"stage 2 DDPM uninterrupted {LATENT_FIT_STEPS}",
                            roots["whole"], LATENT_FIT_STEPS, LATENT_FIT_STEPS,
                            PER_FORWARD_LATENT_CFG, *stage2)
    out["dit_fit"] = run(LATENT_DIT_CONFIG, f"stage 2 DiT fit {LATENT_FIT_STEPS}", roots["dit"],
                         LATENT_FIT_STEPS, LATENT_FIT_STEPS, PER_FORWARD_LATENT_DIT, *stage2)
    for key, root in (("vae_fit", "vae"), ("ddpm_whole", "whole"), ("dit_fit", "dit")):
        logged = _jsonl(os.path.join(roots[root], "metrics.jsonl"))
        out[key]["losses"] = [rec["loss"] for rec in logged]
        out[key]["checkpoints"] = CheckpointManager(roots[root]).steps()
        print(f"{key}: checkpoints {out[key]['checkpoints']}, losses "
              f"{[round(v, 4) for v in out[key]['losses']]}", flush=True)
        if (out[key]["checkpoints"] != [LATENT_FIT_HALF, LATENT_FIT_STEPS]
                or len(logged) != LATENT_FIT_STEPS // LATENT_CHUNK
                or not np.isfinite(out[key]["losses"]).all()):
            fail(f"the latent CLI {key} left {out[key]}")
    a = CheckpointManager(roots["ddpm"]).load(LATENT_FIT_STEPS)
    b = CheckpointManager(roots["whole"]).load(LATENT_FIT_STEPS)
    differ = state_differences(torch, a, b)
    out["resume_bitwise"] = {"differing_tensors": len(differ), "first": differ[:8]}
    print(f"stage 2 resumed vs uninterrupted at step {LATENT_FIT_STEPS}: {len(differ)} of "
          f"{4 * len(a['params'])} tensors differ {differ[:8]}", flush=True)
    if differ or a["step"] != b["step"]:
        fail(f"the resumed stage-2 run is not bitwise the uninterrupted one: {differ[:8]}")
    del a, b

    # sample: the config's own sampler (ancestral DDPM at LATENT_SAMPLE_T
    # steps: a 10-frame trajectory grid) and the DDIM-50 override on the
    # trained T = 1000 schedule, 8 images of 32x32x3 each
    argv = ["--config", LATENT_DDPM_CONFIG, *common, *stage2, "--trainer.default_root_dir",
            roots["ddpm"], "--trainer.sample_batch", str(BATCH)]
    from PIL import Image

    out["sample"] = {}
    for name, extra, forwards, frames in (
            ("default", ["--model.init_args.timesteps", str(LATENT_SAMPLE_T)], LATENT_SAMPLE_T,
             10), ("ddim", ["--trainer.sampler", "ddim"], 50, 1)):
        rec = cli_run(torch, ops, card, f"stage 2 sample ({name})", ["sample", *argv, *extra],
                      launches_for(PER_FORWARD_LATENT_CFG, forwards))
        suffix = "" if name == "default" else "_ddim50"
        path = os.path.join(roots["ddpm"], "samples", f"step_{LATENT_FIT_STEPS:08d}{suffix}.png")
        with Image.open(path) as im:
            rec["png"] = list(im.size[::-1])
        want = list(make_history([np.zeros((BATCH, 32, 32, 3))] * frames).shape[:2])
        rec["png_expected"] = want
        print(f"stage 2 sample ({name}): {path} of {rec['png']} pixels, the grid of {frames} "
              f"frame(s) of {BATCH} images of 32x32x3 ({want})", flush=True)
        if rec["png"] != want:
            fail(f"stage 2 sample ({name}) wrote a grid of {rec['png']}, expected {want}")
        out["sample"][name] = rec
    try:
        cli(["sample", "--config", LATENT_VAE_CONFIG, *common, "--trainer.default_root_dir",
             roots["vae"], "--trainer.sampler", "ddim"])
    except ValueError as e:
        out["vae_sampler_refused"] = str(e)
    print(f"stage 1 sample --trainer.sampler ddim: {out.get('vae_sampler_refused')}", flush=True)
    if "sampler overrides need a diffusion harness" not in out.get("vae_sampler_refused", ""):
        fail("the stage-1 config took a sampler override")

    # TIMED_STEPS timed steps of each harness at batch 128, from the saved states
    torch.backends.cudnn.deterministic = False
    harnesses = {
        "vae": (LATENT_VAE_CONFIG, roots["vae"], []),
        "ddpm_default": (None, roots["vae"], []),
        "dit": (LATENT_DIT_CONFIG, roots["dit"], stage2),
    }
    for key, (path, root, extra) in harnesses.items():
        if path is None:  # the harness default: the latent UNet with both switches, bf16
            lit = LitLatentDDPM(vae=ConvVAE(**LATENT_CODEC, dtype=torch.bfloat16),
                                vae_ckpt=roots["vae"], dtype="bf16")
            state = lit.init_state(0, device=dev)
        else:
            lit = tcfg.instantiate(tcfg.validate_config(tcfg.apply_overrides(
                tcfg.load_config(path), list(extra)))["model"])
            state = CheckpointManager(root).restore(lit.init_state(0, device=dev))
        dm = Shapes(size=4 * TRAIN_BATCH, batch_size=TRAIN_BATCH)
        dm.setup("fit")
        it = dm.train_iter(SEED + 17)

        def batch(it=it):
            return torch.from_numpy(next(it)).pin_memory().to(dev, non_blocking=True)

        step = make_train_step(lit.make_loss_fn(dm))
        state, _ = step(state, batch(), SEED)  # first launches of this step object
        print(f"-- {key} ({type(lit).__name__}): train step at batch {TRAIN_BATCH}", flush=True)
        reset_counts(ops)
        _, out[f"{key}_timing"], out[f"{key}_profile_3_steps"], out[f"{key}_profile_1_step"] = (
            timed_steps(torch, np, step, state, batch, card))
        torch.cuda.synchronize()
        out[f"{key}_launches"] = counts(ops)
        expect_bf16_only(f"{key} timed steps")
        per_step = {"vae": NO_LAUNCHES, "ddpm_default": PER_TRAIN_STEP,
                    "dit": PER_FORWARD_LATENT_DIT}[key]
        want = launches_for(per_step, TIMED_STEPS + 3)
        if out[f"{key}_launches"] != want:
            fail(f"the {key} steps launched {out[f'{key}_launches']}, expected {want}")
        del state, lit, step
        torch.cuda.empty_cache()
    for key, root in roots.items():
        if key not in ("vae", "ddpm"):  # the eval phase tests from these, then removes them
            shutil.rmtree(root, ignore_errors=True)
    out["kept_roots"] = {k: roots[k] for k in ("vae", "ddpm")}
    return out


def latent_serve(torch, np, blocks, dev, ops, card: str) -> dict:
    """Phase 44: the latent harnesses served at 32 px. ``LitLatentDDPM``
    (bf16, default latent UNet and the configs' codec, random weights):
    ``ddim`` (50 steps) and ``dpm`` (20) at n = 8, each repeated for
    identical bytes, 1/6/22 launches a latent forward, images (8, 32, 32,
    3); one ``ddim`` request profiled; the ``default`` ancestral loop (T =
    1000) timed over 20 steps and extrapolated, with the decode. The latent
    DiT's ``LitLatentFlow`` ``default`` (25 midpoint steps) at n = 8. A
    ``LitVAE`` served: ``default`` answered 200 with decoded prior samples,
    ``ddim`` 400 with JAX's message."""
    from dmme_tpu_torch.serving import Sampler
    from dmme_tpu_torch.training import LitVAE, TrainState

    out = {}
    lit, weights = latent_harness(torch, blocks)
    sampler = Sampler(lit, TrainState.create(weights, lit.make_optimizer()), img_size=32,
                      device=dev)
    url, stop = _serve(torch, sampler)
    try:
        _post(url, {"n": BATCH, "seed": 99, "format": "npy", "sampler": "ddim", "steps": 2})
        out["requests"] = solver_requests(np, url, ops, "latent DDPM", card, [
            ("ddim", 50, launches_for(PER_FORWARD, 50)),
            ("dpm", 20, launches_for(PER_FORWARD, 20))])
    finally:
        stop()
    out["launches"] = {k: sum(r["launches"][k] for r in out["requests"]) for k in PER_FORWARD}
    prof = profile_fn(torch, lambda: sampler.sample(BATCH, "ddim", 50, seed=5))
    out["profile_ddim_n8"] = prof
    print(f"latent DDPM ddim n=8 under torch.profiler: wall {prof['wall_ms']:.2f} ms, device "
          f"busy {prof['busy_ms']:.2f} ms in {prof['device_ops']} operations, idle share "
          f"{prof['idle_share']:.3f} [{card}]", flush=True)
    for name, ms, count in prof["top"]:
        print(f"    {ms:9.3f} ms {count:6d}x  {name}", flush=True)

    # the default ancestral loop: 20 of its 1000 steps timed, then the decode
    x = torch.randn((BATCH, *LATENT), generator=torch.Generator().manual_seed(SEED)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    algo, params = lit.diffusion_model.to(dev), sampler.state.ema_params
    with torch.no_grad():
        x = algo.sampling_step(lit.model_fn, params, x, 1000, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(999, 979, -1):
            x = algo.sampling_step(lit.model_fn, params, x, t, gen)
        torch.cuda.synchronize()
        per_step = (time.perf_counter() - t0) / 20
        t0 = time.perf_counter()
        images = lit.to_images(x)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    out["t1000"] = {"step_s": per_step, "decode_s": decode_s,
                    "request_s_extrapolated": 1000 * per_step + decode_s,
                    "finite": bool(images.isfinite().all()), "shape": list(images.shape)}
    print(f"latent DDPM ancestral sampling at n = {BATCH}: {1e3 * per_step:.3f} ms a step (20 "
          f"steps, host clock), decode {1e3 * decode_s:.3f} ms, so "
          f"{out['t1000']['request_s_extrapolated']:.2f} s a default request [{card}]", flush=True)
    if not out["t1000"]["finite"] or out["t1000"]["shape"] != [BATCH, 32, 32, 3]:
        fail(f"the latent ancestral steps: {out['t1000']}")
    del sampler, lit, weights
    torch.cuda.empty_cache()

    lit, weights = latent_harness(torch, blocks, model=latent_config_model(torch,
                                                                           LATENT_DIT_CONFIG),
                                  flow=True)
    sampler = Sampler(lit, TrainState.create(weights, lit.make_optimizer()), img_size=32,
                      device=dev)
    url, stop = _serve(torch, sampler)
    try:
        out["dit"] = {"requests": solver_requests(np, url, ops, "latent DiT", card, [
            ("default", None, launches_for(PER_FORWARD_LATENT_DIT, FLOW_NFE))])}
    finally:
        stop()
    out["dit"]["launches"] = out["dit"]["requests"][0]["launches"]
    del sampler, lit, weights

    vae, weights = latent_codec(torch, blocks)
    lit = LitVAE(model=vae)
    sampler = Sampler(lit, TrainState.create(weights, lit.make_optimizer()), img_size=32,
                      device=dev)
    url, stop = _serve(torch, sampler)
    try:
        out["vae"] = {"requests": solver_requests(np, url, ops, "LitVAE", card,
                                                  [("default", None, NO_LAUNCHES)]),
                      "ddim": rejected(url, "LitVAE", "ddim",
                                       "sampler overrides need a diffusion harness")}
    finally:
        stop()
    torch.cuda.empty_cache()
    return out


def latent_rows(report: dict) -> list:
    """The kernels line's rows of the latent paths: K1/K3/K4 per latent UNet
    forward at n = 8 (launches in the served ddim and dpm requests); K1/K2/K3
    per default ``LitLatentDDPM`` step at batch 128 (launches in its timed
    steps); K3 per step of the stage-2 config's UNet (launches in its
    uninterrupted CLI fit) and per latent DiT forward at n = 8 and step at
    batch 128 (launches in its default request and its CLI fit)."""
    lk, ls, lc = report["latent_kernels"], report["latent_serve"], report["latent_cli"]
    rows = [_table_row(f"{k}_latent", k, lk["per_forward"]["latent"][k], ls["launches"][k])
            for k in ("group_norm_silu", "attention", "resblock")]
    rows += [_table_row(f"{k}_latent_train", k, lk["train"]["per_step"][k],
                        lc["ddpm_default_launches"][k])
             for k in ("group_norm_silu", "group_norm_silu_bwd", "attention")]
    rows.append(_table_row("attention_latent_cfg_train", "attention",
                           lk["cfg_train"]["per_step"]["attention"],
                           lc["ddpm_whole"]["launches"]["attention"]))
    rows.append(_table_row("attention_latent_dit", "attention",
                           lk["per_forward"]["dit"]["attention"],
                           ls["dit"]["launches"]["attention"]))
    rows.append(_table_row("attention_latent_dit_train", "attention",
                           lk["dit_train"]["per_step"]["attention"],
                           lc["dit_fit"]["launches"]["attention"]))
    return rows


EVAL_ROOT = os.path.join("build", "eval")
EVAL_BATCHES = 2  # trainer.limit_test_batches of the eval paths
SPLIT_BATCHES = 2  # timed test batches of the split (after a warm one)
EVAL_FIT_STEPS = 20
DDIM_CONFIG = "configs/ddim/cifar10.yaml"
EVAL_DATA = ["--data.init_args.synthetic", "true"]
#: the f32 Inception on the card (TF32 off) against the unfolded twin on the
#: card and against the port's forward on the CPU, relative L2
INCEPTION_REL_L2 = 1e-5
#: the card's f32 sums Σx and Σxxᵀ against float64 sums of the same features
STATS_REL_L2 = 1e-6
#: ``preprocess`` on the card against the CPU: both compute the bilinear
#: weights in f32 from source coordinates (up to 320 px, ulp 3.1e-5); the CPU
#: and JAX differ by 2.5e-5 at 320 px (tests/test_torch_port_eval_stats.py)
PREPROCESS_ATOL = 5e-5
#: the FID of the card's f32 statistics against the float64 one: 256
#: samples a side in 2048 dimensions leave rank-255 covariances, and the
#: roundoff of the f32 sums enters the square root at ~1,800 eigenvalues
FID_REL = 1e-3
EVAL_KEYS = {"fid", "inception_score", "inception_score_std", "num_batches", "use_ema",
             "sampler", "sample_steps"}


def inception_standin(torch, path: str):
    """A stand-in for pytorch-fid's ``pt_inception-2015-12-05`` file, in its
    layout: tests/torch_inception.py's FID twin, ``randomize``d (random
    weights and BN running statistics), its kernels and BN scales redrawn
    at He scale so that the 2048 features follow the input (at ``randomize``'s
    N(0, 0.1²) kernels they are nearly constant, and every FID ≈ 0). Written
    to ``path``; returns the twin. The file is loaded by its path: ``tests``
    has no ``__init__.py``, and an installed package of that name would win."""
    twin_module = repo_module("torch_inception", os.path.join("tests", "torch_inception.py"))
    twin = twin_module.randomize(twin_module.TorchInceptionV3(variant="fid"), seed=SEED + 11)
    g = torch.Generator().manual_seed(SEED + 11)
    with torch.no_grad():
        for m in twin.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * (2.0 / m.weight[0].numel()) ** 0.5)
            elif isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
        twin.fc.weight.copy_(torch.randn(twin.fc.weight.shape, generator=g) / 2048 ** 0.5)
    torch.save(twin.state_dict(), path)
    return twin


def meta_sites(torch, blocks, build_model, x_shape, **forward_kw) -> dict:
    """K1/K3/K4 calls of one eval forward of ``build_model()`` at the NHWC
    input ``x_shape``, counted on PyTorch's meta device (shapes only), as
    tests/test_torch_port_kernel_plans.py counts them."""
    seen = {"group_norm_silu": 0, "group_norm_silu_bwd": 0, "attention": 0, "resblock": 0}

    def gn(x, gamma, beta, groups, eps=None, pre_bias=None):
        seen["group_norm_silu"] += 1
        return torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)

    def attention(q, k, v, scale, *rest):
        seen["attention"] += 1
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)

    def resblock(x, *args, wr=None, br=None, num_groups=32, eps=None):
        seen["resblock"] += 1
        return torch.empty((*x.shape[:3], args[5].shape[0]), dtype=x.dtype, device=x.device)

    patched = {"group_norm_silu": gn, "attention_heads": attention, "resblock_forward": resblock}
    saved = {k: getattr(blocks, k) for k in patched}
    try:
        for k, fn in patched.items():
            setattr(blocks, k, fn)
        with torch.device("meta"), torch.no_grad():
            model = build_model().eval()
            model(torch.empty(x_shape), torch.zeros((x_shape[0],), dtype=torch.int64),
                  **forward_kw)
    finally:
        for k, fn in saved.items():
            setattr(blocks, k, fn)
    return seen


def _rel(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def eval_inception(torch, np, dev, card: str) -> dict:
    """Phase 45: evaluation's network and statistics on the card. The
    port's ``InceptionV3`` loads the stand-in ``.pth`` through
    ``load_torch_weights`` (BN folded) and runs a batch of 128 CIFAR-sized
    images at 299 px in f32 with TF32 off: against the unfolded twin on the
    card and the port's forward on the CPU within ``INCEPTION_REL_L2``, and
    with TF32 on, which must miss it; ``preprocess`` on the card against the
    CPU at 32 and 320 px; the card's f32 ``FeatureStats`` of 256 + 256
    samples against float64 sums (``STATS_REL_L2``), their moments beside the
    CPU's f32 ones, the FID against the float64 one (``FID_REL``), and
    ``python -m dmme_tpu_torch.fid`` on the same images; then the feature
    function's ms per batch of 128 with TF32 off and on, the statistics
    update's ms and the forward's peak memory."""
    import copy

    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.eval import inception as tinc
    from dmme_tpu_torch.eval.fid import FeatureStats, frechet_distance
    from dmme_tpu_torch.fid import main as fid_tool
    from dmme_tpu_torch.utils.device import ieee_f32

    os.makedirs(EVAL_ROOT, exist_ok=True)
    pth = os.path.join(EVAL_ROOT, "pt_inception_standin.pth")
    twin = inception_standin(torch, pth).to(dev)
    model = tinc.load_torch_weights(tinc.InceptionV3(), pth).eval()
    cpu_model = copy.deepcopy(model)
    model = model.to(dev)
    gen = torch.Generator().manual_seed(SEED + 12)
    x01 = torch.rand((TRAIN_BATCH, 32, 32, 3), generator=gen)
    x = tinc.preprocess(x01)
    out = {"weights": pth}
    with torch.no_grad():
        with ieee_f32():
            got = model(x.to(dev))
            twin_out = twin(x.to(dev).permute(0, 3, 1, 2))
        cpu = cpu_model(x)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = model(x.to(dev))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for i, name in enumerate(("features", "logits")):
        rec = {"vs_twin": _rel(got[i].cpu(), twin_out[i].cpu()),
               "vs_cpu": _rel(got[i].cpu(), cpu[i]), "tf32_vs_cpu": _rel(tf32[i].cpu(), cpu[i])}
        out[name] = rec
        print(f"Inception {name} at batch {TRAIN_BATCH}, f32 on the card, TF32 off: rel L2 "
              f"{rec['vs_twin']:.3e} against the unfolded twin on the card, {rec['vs_cpu']:.3e} "
              f"against the CPU (<= {INCEPTION_REL_L2}); TF32 on: {rec['tf32_vs_cpu']:.3e} "
              f"against the CPU (must miss it)", flush=True)
        if not (rec["vs_twin"] <= INCEPTION_REL_L2 and rec["vs_cpu"] <= INCEPTION_REL_L2):
            fail(f"the f32 Inception {name} on the card disagree: {rec}")
        if not rec["tf32_vs_cpu"] > INCEPTION_REL_L2:
            fail(f"the TF32 control of the Inception {name} does not miss {INCEPTION_REL_L2}")
    del twin, twin_out, cpu_model, tf32

    out["preprocess"] = {}
    for size in (32, 320):
        xs = torch.rand((8, size, size, 3), generator=gen)
        card_pre, cpu_pre = tinc.preprocess(xs.to(dev)).cpu(), tinc.preprocess(xs)
        rec = {"rel_l2": _rel(card_pre, cpu_pre),
               "max_abs": float((card_pre - cpu_pre).abs().max())}
        out["preprocess"][size] = rec
        print(f"preprocess {size} -> 299 on the card against the CPU: rel L2 {rec['rel_l2']:.3e}, "
              f"max abs {rec['max_abs']:.3e} (<= {PREPROCESS_ATOL})", flush=True)
        if not rec["max_abs"] <= PREPROCESS_ATOL:
            fail(f"preprocess at {size} px differs on the card: {rec}")

    # the statistics: 256 synthetic CIFAR-10 images against 256 of noise
    feature_fn = tinc.make_feature_fn(pth, device=dev)
    data = CIFAR10(synthetic=True, synthetic_size=2 * TRAIN_BATCH, batch_size=TRAIN_BATCH)
    data.setup("test")
    sets = {"cifar": data.test_data.astype(np.float32) / np.float32(255),
            "noise": torch.rand((2 * TRAIN_BATCH, 32, 32, 3), generator=gen).numpy()}
    feats, card_stats, cpu_stats = {}, {}, {}
    for name, images in sets.items():
        np.save(os.path.join(EVAL_ROOT, f"{name}.npy"), images)
        parts = [feature_fn(images[i: i + TRAIN_BATCH])[0]
                 for i in range(0, len(images), TRAIN_BATCH)]
        s, c = FeatureStats.create(2048, device=dev), FeatureStats.create(2048)
        for p in parts:
            s, c = s.update(p), c.update(p.cpu())
        feats[name] = torch.cat(parts).cpu().double().numpy()
        card_stats[name], cpu_stats[name] = s, c
    stats = {}
    for name, f in feats.items():
        s = card_stats[name]
        mu64, cov64 = f.mean(axis=0), np.cov(f, rowvar=False)
        mu, cov = s.moments()
        mu_c, cov_c = cpu_stats[name].moments()
        rec = {"sum_rel_l2": _rel(s.sum.cpu(), torch.from_numpy(f.sum(axis=0))),
               "outer_rel_l2": _rel(s.outer.cpu(), torch.from_numpy(f.T @ f)),
               "mu_rel_l2": float(np.linalg.norm(mu - mu64) / np.linalg.norm(mu64)),
               "cov_rel_l2": float(np.linalg.norm(cov - cov64) / np.linalg.norm(cov64)),
               "cpu_cov_rel_l2": float(np.linalg.norm(cov_c - cov64) / np.linalg.norm(cov64)),
               "mean_sq_over_var": float(np.mean(mu64 ** 2) / np.mean(np.diag(cov64)))}
        with torch.no_grad():  # the control: the same product with TF32 on
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                fd = torch.from_numpy(f).float().to(dev)
                rec["tf32_outer_rel_l2"] = _rel(torch.matmul(fd.T, fd).cpu(),
                                                torch.from_numpy(f.T @ f))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        stats[name] = rec
        print(f"FeatureStats of {len(f)} {name} feature vectors, f32 on the card against float64: "
              f"Σx {rec['sum_rel_l2']:.3e}, Σxxᵀ {rec['outer_rel_l2']:.3e} (<= {STATS_REL_L2}; "
              f"TF32 on: {rec['tf32_outer_rel_l2']:.3e}); moments μ {rec['mu_rel_l2']:.3e}, "
              f"Σ {rec['cov_rel_l2']:.3e} (the CPU's f32 sums: {rec['cpu_cov_rel_l2']:.3e}; "
              f"|μ|²/σ² {rec['mean_sq_over_var']:.1f} sets the cancellation)", flush=True)
        if not (rec["sum_rel_l2"] <= STATS_REL_L2 and rec["outer_rel_l2"] <= STATS_REL_L2):
            fail(f"the card's f32 feature sums of {name} miss {STATS_REL_L2}: {rec}")
        if not rec["cov_rel_l2"] <= max(STATS_REL_L2, 4 * rec["cpu_cov_rel_l2"]):
            fail(f"the card's covariance of {name} is worse than the CPU's f32 one: {rec}")
    out["stats"] = stats
    fid64 = frechet_distance(feats["cifar"].mean(0), np.cov(feats["cifar"], rowvar=False),
                             feats["noise"].mean(0), np.cov(feats["noise"], rowvar=False))
    fid_card = frechet_distance(*card_stats["cifar"].moments(), *card_stats["noise"].moments())
    fid_cpu = frechet_distance(*cpu_stats["cifar"].moments(), *cpu_stats["noise"].moments())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fid_tool([os.path.join(EVAL_ROOT, "cifar.npy"), os.path.join(EVAL_ROOT, "noise.npy"),
                  "--weights", pth, "--batch-size", str(TRAIN_BATCH)])
    fid_cli = float(buf.getvalue().strip().splitlines()[-1].split()[-1])
    out["fid"] = {"float64": fid64, "card": fid_card, "cpu_f32": fid_cpu, "fid_tool": fid_cli,
                  "card_rel": abs(fid_card - fid64) / abs(fid64),
                  "cpu_rel": abs(fid_cpu - fid64) / abs(fid64)}
    # the bound: FID_REL, or what the CPU's f32 sums of the same features leave
    bound = out["fid"]["bound"] = max(FID_REL, 4 * out["fid"]["cpu_rel"])
    print(f"FID cifar vs noise ({len(feats['cifar'])} a side): float64 {fid64:.6f}, the card's "
          f"f32 statistics {fid_card:.6f} (rel {out['fid']['card_rel']:.3e}, <= {bound:.3e}: "
          f"{'FID_REL' if bound == FID_REL else '4x the CPU f32 error'}), the CPU's f32 "
          f"{fid_cpu:.6f} (rel {out['fid']['cpu_rel']:.3e}); python -m dmme_tpu_torch.fid "
          f"on the card: {fid_cli:.6f}", flush=True)
    if not out["fid"]["card_rel"] <= bound or abs(fid_cli - fid_card) > 1e-6 * abs(fid_card):
        fail(f"the FID of the card's statistics is off: {out['fid']}")

    xd = x01.to(dev)
    deterministic = torch.backends.cudnn.deterministic
    try:  # a user's cuDNN defaults (any algorithm), then the deterministic ones
        for det in (False, True):
            torch.backends.cudnn.deterministic = det
            tag = "_deterministic" if det else ""
            out[f"inception{tag}_ms"] = device_ms(torch, lambda: feature_fn(xd), reps=10)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:  # the same network and inputs with TF32 allowed, outside the feature function
                with torch.no_grad():
                    out[f"inception_tf32{tag}_ms"] = device_ms(
                        torch, lambda: model(tinc.preprocess(xd)), reps=10)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    finally:
        torch.backends.cudnn.deterministic = deterministic
    f0 = feature_fn(xd)[0]
    s0 = FeatureStats.create(2048, device=dev)
    out["stats_update_ms"] = device_ms(torch, lambda: s0.update(f0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    feature_fn(xd)
    torch.cuda.synchronize()
    out["forward_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    print(f"Inception feature function, batch {TRAIN_BATCH} at 32 -> 299 px, cuDNN's defaults: "
          f"{out['inception_ms']:.3f} ms with TF32 off, {out['inception_tf32_ms']:.3f} ms with "
          f"TF32 on (deterministic cuDNN: {out['inception_deterministic_ms']:.3f} and "
          f"{out['inception_tf32_deterministic_ms']:.3f}); FeatureStats.update "
          f"{out['stats_update_ms']:.4f} ms; forward peak {out['forward_peak_gib']:.3f} GiB "
          f"above its weights [{card}]", flush=True)
    del model, feature_fn, xd, f0, s0
    torch.cuda.empty_cache()
    return out


def _test_run(torch, np, ops, card: str, name: str, argv, want: dict,
              batches: int = EVAL_BATCHES) -> dict:
    """``trainer.main(["test", ...])`` through :func:`cli_run`, its printed
    results parsed: JAX's keys, ``batches`` scored, finite values, no
    ``warning``."""
    import ast

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = cli_run(torch, ops, card, name, ["test", *argv], want)
    print(buf.getvalue(), end="", flush=True)
    results = ast.literal_eval([line for line in buf.getvalue().splitlines()
                                if line.startswith("{'fid'")][-1])
    rec["results"] = results
    print(f"{name}: {results}", flush=True)
    if (set(results) != EVAL_KEYS or results["num_batches"] != batches
            or not all(np.isfinite(results[k]) for k in ("fid", "inception_score",
                                                         "inception_score_std"))):
        fail(f"{name} returned {results}")
    return rec


def eval_test(torch, np, blocks, k_gn, k_attn, k_res, build, ops, dev, card: str,
              latent_roots: dict) -> dict:
    """Phase 46: ``trainer.main test`` on the card (deterministic cuDNN),
    ``limit_test_batches`` 2 of 128, the stand-in Inception weights:
    configs/ddim/cifar10.yaml from a 20-step ``fit`` (DDIM-50: launches 50 ×
    the UNet's call sites a batch, counted on the meta device) with
    ``save_fid_stats``, with ``fid_stats`` (the same FID within 1e-6) and
    repeated (bitwise the same results); with ``--trainer.sampler dpm``
    (20 steps); configs/ddpm/shapes_cfg_demo.yaml with ``--trainer.sampler
    ddim`` (one guided call at N = 256 a step); configs/latent/shapes_latent_demo.yaml
    from the latent CLI phase's runs (``latent_roots``; removed here), the
    fakes decoded to 32×32×3; the stage-1 ``LitVAE`` config and
    ``--trainer.sampler cached`` refused with JAX's messages. Every
    K1/K3/K4 call of the first run is held against its plain version
    (``TOL``), repeated for identical bytes, and timed. Then one test batch
    split: generation s, Inception ms, statistics ms, the device's idle
    share from a profile."""
    import shutil

    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.models import ddpm as ddpm_models
    from dmme_tpu_torch.trainer import main as cli

    torch.backends.cudnn.deterministic = True
    pth = os.path.join(EVAL_ROOT, "pt_inception_standin.pth")
    roots = {k: os.path.join("build", f"eval_{k}") for k in ("ddim", "cfg")}
    for root in roots.values():
        shutil.rmtree(root, ignore_errors=True)
    stats_path = os.path.join(EVAL_ROOT, "real_stats.npz")
    out = {}
    fit_rec = cli_run(torch, ops, card, f"eval: fit {EVAL_FIT_STEPS} of {DDIM_CONFIG}",
                      ["fit", "--config", DDIM_CONFIG, *EVAL_DATA,
                       "--trainer.max_steps", str(EVAL_FIT_STEPS),
                       "--trainer.ckpt_every_n_steps", str(EVAL_FIT_STEPS),
                       "--trainer.log_every_n_steps", "10", "--trainer.callbacks", "[]",
                       "--trainer.default_root_dir", roots["ddim"]],
                      launches_for(PER_TRAIN_STEP, EVAL_FIT_STEPS))
    out["fit"] = fit_rec
    sites = {"ddim": meta_sites(torch, blocks, lambda: ddpm_models.UNet(
                 dtype=torch.bfloat16, fused_norm=True, fused_block=True),
                 (TRAIN_BATCH, 32, 32, 3)),
             "cfg": meta_sites(torch, blocks, lambda: ddpm_models.UNet(
                 dtype=torch.bfloat16, fused_norm=True, fused_block=True, num_classes=2),
                 (2 * TRAIN_BATCH, 32, 32, 3),
                 y=torch.zeros((2 * TRAIN_BATCH,), dtype=torch.int64, device="meta")),
             "latent": meta_sites(torch, blocks, lambda: tcfg.instantiate(
                 tcfg.load_config(LATENT_DDPM_CONFIG)["model"]["init_args"]["model"]),
                 (TRAIN_BATCH, 16, 16, 4))}
    out["sites"] = sites
    print(f"call sites of one forward on the meta device: {sites}", flush=True)
    if sites["ddim"] != PER_FORWARD:
        fail(f"the DDIM config's UNet has call sites {sites['ddim']}, expected {PER_FORWARD}")

    ddim = ["--config", DDIM_CONFIG, *EVAL_DATA, "--trainer.default_root_dir", roots["ddim"],
            "--trainer.limit_test_batches", str(EVAL_BATCHES), "--trainer.inception_weights", pth]
    recorded = {}

    def first():
        out["save"] = _test_run(torch, np, ops, card, "eval: test DDIM-50, save_fid_stats",
                                [*ddim, "--trainer.save_fid_stats", stats_path],
                                launches_for(sites["ddim"], EVAL_BATCHES * 50))

    calls = record_calls(serve_targets(blocks), first)
    forwards = EVAL_BATCHES * 50
    for kind, lst in calls.items():
        recorded[kind] = {key: {"a": a, "k": k, "sites": {"eval": count // forwards}}
                          for key, count, a, k in lst}
    per_call = {k: sum(e["sites"]["eval"] for e in v.values()) for k, v in recorded.items()}
    if per_call != {k: sites["ddim"][k] for k in per_call}:
        fail(f"the recorded calls per forward {per_call} are not the call sites {sites['ddim']}")
    out["stats"] = _test_run(torch, np, ops, card, "eval: test DDIM-50, fid_stats",
                             [*ddim, "--trainer.fid_stats", stats_path],
                             launches_for(sites["ddim"], forwards))
    out["repeat"] = _test_run(torch, np, ops, card, "eval: test DDIM-50, repeated", ddim,
                              launches_for(sites["ddim"], forwards))
    a, b = out["save"]["results"], out["stats"]["results"]
    if abs(a["fid"] - b["fid"]) > 1e-6 * abs(a["fid"]):
        fail(f"the fid_stats run's FID {b['fid']} is not the save_fid_stats run's {a['fid']}")
    if out["repeat"]["results"] != a:
        fail(f"a repeated test differs: {out['repeat']['results']} against {a}")
    # the other samplers and configs score one batch each (a run's depth)
    one = ["--trainer.limit_test_batches", "1"]
    out["dpm"] = _test_run(torch, np, ops, card, "eval: test --trainer.sampler dpm (20 steps)",
                           [*ddim, "--trainer.sampler", "dpm", *one],
                           launches_for(sites["ddim"], 20), batches=1)
    out["cfg"] = _test_run(torch, np, ops, card, f"eval: test {CFG_CONFIG} --trainer.sampler ddim",
                           ["--config", CFG_CONFIG, *SHAPES_CUT, "--trainer.default_root_dir",
                            roots["cfg"], *one, "--trainer.inception_weights", pth,
                            "--trainer.sampler", "ddim"],
                           launches_for(sites["cfg"], 50), batches=1)
    out["latent"] = _test_run(torch, np, ops, card,
                              f"eval: test {LATENT_DDPM_CONFIG} --trainer.sampler ddim",
                              ["--config", LATENT_DDPM_CONFIG, *LATENT_DATA,
                               "--model.init_args.vae_ckpt", latent_roots["vae"],
                               "--trainer.default_root_dir", latent_roots["ddpm"], *one,
                               "--trainer.inception_weights", pth, "--trainer.sampler", "ddim"],
                              launches_for(sites["latent"], 50), batches=1)
    out["refused"] = {}
    for key, argv, needle in (
            ("vae", ["--config", LATENT_VAE_CONFIG, *LATENT_DATA, "--trainer.default_root_dir",
                     latent_roots["vae"]], "evaluate() scores diffusion harnesses"),
            ("cached", [*ddim, "--trainer.sampler", "cached"],
             "unknown sampler 'cached' (ddim|dpm|edm|unipc|flow)")):
        try:
            cli(["test", *argv])
        except ValueError as e:
            out["refused"][key] = str(e)
        print(f"eval: test refused ({key}): {out['refused'].get(key)}", flush=True)
        if needle not in out["refused"].get(key, ""):
            fail(f"test did not refuse {key} with JAX's message")

    rows, failures = forward_rows(torch, k_gn, k_attn, k_res, build, dev, recorded)
    if failures:
        fail(f"the eval path's kernels disagree with their plain versions: {failures}")
    out["rows"] = rows
    out["per_forward"] = _per_forward(rows, "eval", card,
                                      f"DDIM-50 forward of a test batch (N = {TRAIN_BATCH})")
    del calls, recorded
    k_res._PACKED.clear()
    torch.cuda.empty_cache()
    out["split"] = eval_batch_split(torch, np, dev, card, roots["ddim"], pth)
    out["kept_root"] = roots["ddim"]  # the two-rank test's (phase 50), removed there
    for root in (roots["cfg"], *latent_roots.values()):
        shutil.rmtree(root, ignore_errors=True)
    return out


def eval_batch_split(torch, np, dev, card: str, root: str, pth: str) -> dict:
    """One ``test`` batch of 128 of the DDIM config's trained run, under a
    user's cuDNN defaults, in parts: generation (DDIM-50, host clock), the
    Inception feature function and the statistics update (CUDA events); the
    whole batch on the host clock (median of ``SPLIT_BATCHES``), which extrapolates to a
    50,000-sample FID, and under the profiler (device busy, idle share)."""
    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.data import CIFAR10
    from dmme_tpu_torch.eval import (FeatureStats, FrechetInceptionDistance, InceptionScore,
                                     make_feature_fn)
    from dmme_tpu_torch.parallel.train_step import step_generator
    from dmme_tpu_torch.training import CheckpointManager
    from dmme_tpu_torch.utils.norm import denorm

    lit = tcfg.instantiate(tcfg.validate_config(tcfg.load_config(DDIM_CONFIG))["model"])
    state = CheckpointManager(root).restore(lit.init_state(0, device=dev))
    feature_fn = make_feature_fn(pth, device=dev)
    data = CIFAR10(synthetic=True, synthetic_size=TRAIN_BATCH, batch_size=TRAIN_BATCH)
    data.setup("test")
    real = torch.from_numpy(data.test_data).to(dev).float() / 255.0
    shape = tuple(real.shape)

    def generate():
        with torch.no_grad():
            return lit.diffusion_model.generate(lit.model_fn, state.ema_params,
                                                step_generator(SEED, 0, dev), shape)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    generate()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fake = denorm(generate())
    torch.cuda.synchronize()
    out = {"generation_s": time.perf_counter() - t0}
    out["inception_ms"] = device_ms(torch, lambda: feature_fn(fake), reps=10)
    feats = feature_fn(fake)[0]
    empty = FeatureStats.create(2048, device=dev)
    out["stats_ms"] = device_ms(torch, lambda: empty.update(feats))
    fid, inception = FrechetInceptionDistance(), InceptionScore()

    def batch():
        fid.update(feature_fn(real)[0], real=True)
        f, logits = feature_fn(denorm(generate()))
        fid.update(f, real=False)
        inception.update(logits)

    walls = []
    for _ in range(1 + SPLIT_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["batch_wall_s"] = statistics.median(walls[1:])
    prof = profile_fn(torch, batch)
    out["profile"] = prof
    # the profiler slows the host: the busy time over the unprofiled wall too
    out["idle_share_host_clock"] = 1.0 - prof["busy_ms"] / (1e3 * out["batch_wall_s"])
    torch.backends.cudnn.deterministic = deterministic
    batches = -(-50_000 // TRAIN_BATCH)
    out["fid50k_chip_s"] = batches * out["batch_wall_s"]
    print(f"one test batch of {TRAIN_BATCH}: generation (DDIM-50) {out['generation_s']:.3f} s, "
          f"Inception {out['inception_ms']:.3f} ms a pass (two a batch), statistics update "
          f"{out['stats_ms']:.4f} ms; the whole batch {out['batch_wall_s']:.3f} s (median of "
          f"{SPLIT_BATCHES}); "
          f"profiled: wall {prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms in "
          f"{prof['device_ops']} operations, idle share {prof['idle_share']:.3f} "
          f"({out['idle_share_host_clock']:.3f} of the unprofiled wall); a 50,000-sample "
          f"FID: {batches} batches ≈ {out['fid50k_chip_s']:.0f} s of chip time [{card}]",
          flush=True)
    for name, ms, count in prof["top"]:
        print(f"    {ms:9.3f} ms {count:6d}x  {name}", flush=True)
    del lit, state, feature_fn, fake, feats
    torch.cuda.empty_cache()
    return out


def eval_rows(report: dict) -> list:
    """The kernels line's rows of the evaluation path: K1/K3/K4 per DDIM-50
    forward of a test batch at N = 128 (50 a batch), launches in the
    ``save_fid_stats`` run's two batches."""
    ev = report["eval_test"]
    return [_table_row(f"{k}_eval", k, ev["per_forward"][k], ev["save"]["launches"][k])
            for k in ("group_norm_silu", "attention", "resblock")]


LSUN_CONFIG = "configs/ddpm/lsun_church.yaml"
LSUN_ROOT = os.path.join("build", "lsun")
LSUN_IMAGES = 96  # synthetic JPEGs in the LMDB
LSUN_SIZES = ((256, 341), (300, 256))  # their (H, W), non-square as LSUN's
LSUN_FIT_STEPS = 2
#: the config's UNet leaves the kernels off: turn on K1/K2 (``fused_norm``) and K4
#: (``fused_block``), as ``LitDDPM``'s default UNet has them
#: phase 47's cuts in depth: 8 microbatches a step (the config accumulates
#: 32) and a DDPM of 100 steps, whose grid samples 100 forwards, not 1000
LSUN_DEPTH = ["--trainer.accumulate_grad_batches", "4", "--model.init_args.timesteps", "100"]
#: the card-against-CPU gradient's batch and size: the f32 CPU reference at
#: 256 px took 37 s at the config's batch of 2 and ≈ 14 s at 1; its kernels'
#: shapes at batch 2 and 256 px are held by the microbatch's rows, so the
#: gradient of the same UNet runs at 128 px
LSUN_GRAD_BATCH, LSUN_GRAD_SIZE = 1, 128
#: microbatches of the streaming step: the streaming reader's check needs
#: one optimizer step, not the config's depth
LSUN_STREAM_ACCUM = 2
LSUN_KERNELS = ["--model.init_args.model.init_args.fused_norm", "true",
                "--model.init_args.model.init_args.fused_block", "true"]
IN64_CONFIG = "configs/iddpm/imagenet64.yaml"
IN64_ROOT = os.path.join("build", "in64")
IN64_ROWS = 512  # rows of the synthetic train_data_batch_1.npz
IN64_FIT_STEPS = 3
#: the config's UNet leaves K4 off (``fused_block`` false): the sample turns it on
IN64_BLOCK = ["--model.init_args.model.init_args.fused_block", "true"]
IN64_BATCH = 2  # the gradient check's batch
#: K1, K2, K3 kernels by name in a profiler trace
TRACE_KERNELS = {"group_norm_silu": ("gn_fwd_cluster_kernel", "gn_apply_kernel"),
                 "group_norm_silu_bwd": ("gn_bwd_cluster_kernel", "gn_dx_kernel"),
                 "attention": ("attn_fwd_kernel",)}


def repo_module(name: str, relpath: str):
    """A module of the repository loaded by its path (``tests`` has no
    ``__init__.py``, and an installed package of that name would win)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)), relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def config_sites(torch, blocks, model_node) -> tuple:
    """(per training microbatch, per eval forward) K1/K2/K3/K4 launches of a
    config's UNet, counted from its modules on the meta device: a step
    launches K1 at its 2r + 1 GroupNorm+SiLU sites (r ResBlocks, the output
    norm) and K3 at its n attention sites (each inside a ResBlock), and
    again at the ResBlocks' 2r and n under ``remat``, whose backward
    recomputes them; K2 at the 2r + 1. An eval forward (``fused_block``
    on) launches K1 once, K3 n times and K4 r times. Third: the calls of a
    microbatch's entry points (:func:`train_targets`), the attention
    backward's n among them."""
    from dmme_tpu_torch import config as tcfg

    with torch.device("meta"):
        model = tcfg.instantiate(model_node)
    r = sum(isinstance(m, blocks.ResBlock) for m in model.modules())
    n = sum(isinstance(m, blocks.SelfAttention2d) for m in model.modules())
    again = 2 if model_node["init_args"].get("remat") else 1
    train = {"group_norm_silu": again * 2 * r + 1, "group_norm_silu_bwd": 2 * r + 1,
             "attention": again * n, "resblock": 0}
    if not model_node["init_args"].get("fused_block"):
        fail(f"{model_node['class_path']}: the sampling forward's count needs fused_block")
    forward = {"group_norm_silu": 1, "group_norm_silu_bwd": 0, "attention": n, "resblock": r}
    calls = {k: train[k] for k in ("group_norm_silu", "group_norm_silu_bwd", "attention")}
    return train, forward, dict(calls, attention_bwd=n)


def write_lsun_lmdb(np, path: str, images: int = LSUN_IMAGES) -> int:
    """``images`` JPEGs of ``LSUN_SIZES`` drawn from the seed (smooth
    colour fields with noise, as photographs compress) into an LMDB at
    ``path``, written by tests/lmdb_fixture.py. Returns its bytes."""
    from PIL import Image

    fixture = repo_module("lmdb_fixture", os.path.join("tests", "lmdb_fixture.py"))
    rng = np.random.default_rng(SEED + 60)
    kv = {}
    for i in range(images):
        h, w = LSUN_SIZES[i % len(LSUN_SIZES)]
        coarse = Image.fromarray(rng.integers(0, 256, (h // 32, w // 32, 3), np.uint8))
        smooth = np.asarray(coarse.resize((w, h), Image.BILINEAR), np.int16)
        img = np.clip(smooth + rng.integers(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG", quality=90)
        kv[f"{i:040x}".encode()] = buf.getvalue()
    fixture.write_lmdb(os.path.join(path, "data.mdb"), kv)
    return sum(len(v) for v in kv.values())


def trace_kernels(path: str) -> dict:
    """{kernel: launches} of K1, K2 and K3 in a profiler trace file, and the
    traced window's device busy ms and idle share (kernels, copies and
    memsets over the span of its device events)."""
    device = device_events(path)
    if not device:
        fail(f"no device event in the trace {path}")
    found = {k: sum(1 for cat, name, _, _ in device
                    if cat == "kernel" and any(n in name for n in names))
             for k, names in TRACE_KERNELS.items()}
    busy = sum(d for *_, d in device) / 1e3
    span = (max(t + d for *_, t, d in device) - min(t for *_, t, _ in device)) / 1e3
    return {"launches": found, "busy_ms": busy, "span_ms": span, "idle_share": 1.0 - busy / span,
            "device_events": len(device), "bytes": os.path.getsize(path)}


def config_pair(torch, model_node) -> tuple:
    """(card, reference) modules of a config's UNet: bf16 as configured, and
    f32 without remat (the same math)."""
    from dmme_tpu_torch import config as tcfg

    args = model_node["init_args"]
    return (tcfg.instantiate(dict(model_node, init_args=dict(args, dtype="bf16"))),
            tcfg.instantiate(dict(model_node, init_args=dict(args, dtype="f32", remat=False))))


def config_draws(torch, np, shape, timesteps: int, t_low: int) -> tuple:
    """Numpy x₀ in [−1, 1], t from ``t_low`` and ε at ``shape``."""
    r = np.random.default_rng(SEED + 61)
    x0 = torch.tensor(np.clip(r.standard_normal(shape), -1, 1).astype(np.float32))
    t = torch.tensor(r.integers(t_low, timesteps, (shape[0],)), dtype=torch.int64)
    eps = torch.tensor(r.standard_normal(shape).astype(np.float32))
    return x0, t, eps


def remat_peaks(torch, blocks, lit, dm, batch_size: int, img_size: int, dev, card: str,
                label: str) -> dict:
    """The peak memory one training microbatch's loss and gradient
    allocate on the card (``lit``'s UNet at the config's widths, batch and
    size, flip and draws of its loss) with its ResBlocks' remat on and off:
    remat must lower it. {True: GiB, False: GiB}."""
    params = {k: v.detach().to(dev).requires_grad_(True)
              for k, v in lit.model.state_dict().items()}
    batch = torch.randint(0, 256, (batch_size, img_size, img_size, 3), device=dev,
                          dtype=torch.uint8,
                          generator=torch.Generator(device=dev).manual_seed(SEED))
    loss_fn = lit.make_loss_fn(dm)
    res = [m for m in lit.model.modules() if isinstance(m, blocks.ResBlock)]
    was = [m.remat for m in res]
    peaks = {}
    try:
        for remat in (True, False):
            for m in res:
                m.remat = remat
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loss = loss_fn(params, torch.Generator(device=dev).manual_seed(SEED), batch)
            torch.autograd.grad(loss, list(params.values()))
            del loss
            torch.cuda.synchronize()
            peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2**30
    finally:
        for m, r in zip(res, was):
            m.remat = r
    del params, batch
    torch.cuda.empty_cache()
    print(f"{label}: a microbatch's loss and gradient (batch {batch_size}, {img_size} px) "
          f"allocate a peak of {peaks[True]:.3f} GiB with remat, {peaks[False]:.3f} GiB without "
          f"[{card}]", flush=True)
    if not peaks[True] < peaks[False]:
        fail(f"{label}: remat did not lower the peak memory: {peaks}")
    return peaks


def lsun_fit(torch, np, blocks, k_gn, k_attn, k_res, build, init_weights, ops, dev,
             card: str) -> dict:
    """Phase 47: configs/ddpm/lsun_church.yaml on the card through
    ``trainer.main``, its recipe (batch 2, 256 px, remat, bf16, the LSUN
    widths; ``LSUN_KERNELS`` and ``log_every_n_steps`` 1 added) cut in depth
    by ``LSUN_DEPTH`` (microbatches a step, the DDPM's T), on a synthetic
    LMDB of ``LSUN_IMAGES`` JPEGs of mixed sizes read by the native scanner
    and decoded into the memmap cache: ``LSUN_FIT_STEPS`` steps with the
    config's GenerateImage (a T-step DDPM, 4 samples at 256 px, at the end)
    and ``ProfileTrace`` over step 2; the launches of the steps (steps ×
    microbatches × a microbatch's call sites) and of the grid (T × a
    sampling forward's) each counted around
    the grid, no f32, fp16 or ``simt.cu`` launch; the trace names K1, K2
    and K3 (its device busy time and idle share are the step's); the losses
    finite; one more step resumed in streaming mode; each step's host time
    from the fit's log, the grid's, and the peak memory. Then the decode's
    host time, every K1/K3/K4 call of a sampling forward at n = 4 and every
    K1/K2/K3 call of one microbatch held against its plain version, twice
    for identical bytes, and timed, and the bf16 microbatch gradient and
    forward against the f32 CPU port (at ``LSUN_GRAD_SIZE``)."""
    import shutil

    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.callbacks import GenerateImage
    from dmme_tpu_torch.data import lsun as lsun_data
    from dmme_tpu_torch.datasets import lsun as lsun_datasets
    from dmme_tpu_torch.training import CheckpointManager

    shutil.rmtree(LSUN_ROOT, ignore_errors=True)
    data_dir, run = os.path.join(LSUN_ROOT, "data"), os.path.join(LSUN_ROOT, "run")
    profile_dir = os.path.join(LSUN_ROOT, "profile")
    t0 = time.time()
    nbytes = write_lsun_lmdb(np, os.path.join(data_dir, "church_outdoor_train_lmdb"))
    out = {"lmdb_bytes": nbytes, "lmdb_write_s": time.time() - t0}
    data_args = ["--data.init_args.data_dir", data_dir]
    config = tcfg.validate_config(tcfg.apply_overrides(tcfg.load_config(LSUN_CONFIG),
                                                       LSUN_KERNELS + LSUN_DEPTH + data_args))
    accumulate = config["trainer"]["accumulate_grad_batches"]
    imgsize, batch_size = (config["data"]["init_args"][k] for k in ("imgsize", "batch_size"))
    model_node = config["model"]["init_args"]["model"]
    train, forward, calls = config_sites(torch, blocks, model_node)
    lit = tcfg.instantiate(config["model"])
    timesteps = lit.diffusion_model.timesteps
    n = config["trainer"]["callbacks"][0]["init_args"]["num_samples"]
    print(f"LSUN: {LSUN_IMAGES} JPEGs of {LSUN_SIZES} (H, W), {nbytes / 2**20:.1f} MiB, written "
          f"in {out['lmdb_write_s']:.1f} s; launches a training microbatch {train}, a sampling "
          f"forward {forward}", flush=True)

    # the decode's host time: the memmap mode's decode of every image (into
    # RAM here), and batches of the streaming mode
    dm = lsun_data.LSUN(data_dir=data_dir, category="church_outdoor", imgsize=imgsize,
                        cache_decoded=False)
    t0 = time.perf_counter()
    dm.setup("fit")
    out["decode_s"] = time.perf_counter() - t0
    stream = lsun_data.LSUN(data_dir=data_dir, category="church_outdoor", imgsize=imgsize,
                            batch_size=batch_size, streaming=True)
    stream.setup("fit")
    it = stream.train_iter(SEED)
    next(it)
    t0 = time.perf_counter()
    for _ in range(accumulate):
        next(it)
    out["stream_ms_per_batch"] = 1e3 * (time.perf_counter() - t0) / accumulate
    it.close()
    print(f"decode on {dm.num_workers} threads: {LSUN_IMAGES} images in {out['decode_s']:.3f} s "
          f"({1e3 * out['decode_s'] / LSUN_IMAGES:.2f} ms an image); streaming "
          f"{out['stream_ms_per_batch']:.2f} ms a batch of {batch_size} [{card}]", flush=True)
    del dm, stream

    callbacks = [dict(cb, init_args=dict(cb["init_args"], out_dir=os.path.join(run, "samples")))
                 for cb in config["trainer"]["callbacks"]]
    callbacks.append({"class_path": "dmme_tpu.callbacks.ProfileTrace",
                      "init_args": {"start_step": 1, "num_steps": 1, "log_dir": profile_dir}})
    argv = ["fit", "--config", LSUN_CONFIG, *LSUN_KERNELS, *LSUN_DEPTH, *data_args,
            "--trainer.default_root_dir", run, "--trainer.max_steps", str(LSUN_FIT_STEPS),
            "--trainer.log_every_n_steps", "1", "--trainer.callbacks", json.dumps(callbacks)]
    backends, grid = [], []
    opened, generate = lsun_datasets.open_lmdb, GenerateImage.generate_and_save

    def recording(path, prefer_native=True):
        reader = opened(path, prefer_native)
        backends.append(reader.backend)
        return reader

    def counted(self, *args, **kwargs):
        # the launches of the fit's training steps and of its grid, apart
        torch.cuda.synchronize()
        before, t0 = counts(ops), time.perf_counter()
        path = generate(self, *args, **kwargs)
        torch.cuda.synchronize()
        grid.append((before, counts(ops), time.perf_counter() - t0))
        return path

    lsun_datasets.open_lmdb = lsun_data.open_lmdb = recording
    GenerateImage.generate_and_save = counted
    try:
        torch.cuda.reset_peak_memory_stats()
        out["fit"] = cli_run(torch, ops, card, f"LSUN fit {LSUN_FIT_STEPS} steps", argv)
        out["fit"]["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if len(grid) != 1:
            fail(f"the LSUN fit's GenerateImage sampled {len(grid)} times, not once at its end")
        before, after, out["grid_s"] = grid[0]
        out["train_launches"] = {k: out["fit"]["launches"][k] - after[k] + before[k] for k in train}
        out["sample_launches"] = {k: after[k] - before[k] for k in train}
        want = {k: LSUN_FIT_STEPS * accumulate * v for k, v in train.items()}
        print(f"LSUN fit: launches in the {LSUN_FIT_STEPS} steps {out['train_launches']} "
              f"(expected {want}), in the grid {out['sample_launches']} (expected {timesteps} x "
              f"{forward}); the grid's {timesteps}-step DDPM at n = {n} {out['grid_s']:.2f} s "
              f"[{card}]", flush=True)
        if out["train_launches"] != want:
            fail(f"the LSUN fit's steps launched {out['train_launches']}, expected {want}")
        if out["sample_launches"] != launches_for(forward, timesteps):
            fail(f"the LSUN fit's grid launched {out['sample_launches']}, expected "
                 f"{timesteps} x {forward}")
        out["streaming"] = cli_run(
            torch, ops, card, "LSUN fit, one more step streaming",
            ["fit", "--config", LSUN_CONFIG, *LSUN_KERNELS, *LSUN_DEPTH, *data_args,
             "--trainer.default_root_dir", run, "--trainer.max_steps", str(LSUN_FIT_STEPS + 1),
             "--trainer.log_every_n_steps", "1", "--trainer.resume", "true",
             "--trainer.accumulate_grad_batches", str(LSUN_STREAM_ACCUM),
             "--data.init_args.streaming", "true", "--trainer.callbacks", "[]"],
            {k: LSUN_STREAM_ACCUM * v for k, v in train.items()})
    finally:
        lsun_datasets.open_lmdb = lsun_data.open_lmdb = opened
        GenerateImage.generate_and_save = generate
    out["backends"] = backends
    cache = os.path.join(data_dir, f"church_outdoor_train_decoded_{imgsize}.npy")
    logged = _jsonl(os.path.join(run, "metrics.jsonl"))
    out["losses"] = [r["loss"] for r in logged]
    # each optimizer step's host time, from imgs_per_sec over a logging
    # interval of one step: step 1, step 2 under the profiler, the resumed
    # streaming step
    out["step_s"] = [m * batch_size / r["imgs_per_sec"] for m, r in zip(
        [accumulate] * LSUN_FIT_STEPS + [LSUN_STREAM_ACCUM], logged)]
    grids = os.listdir(os.path.join(run, "samples"))
    traces = [os.path.join(profile_dir, f) for f in os.listdir(profile_dir)
              if f.endswith(".pt.trace.json")]
    out["trace"] = trace_kernels(traces[0]) if len(traces) == 1 else None
    print(f"LSUN fit: readers {backends}; decode cache {cache} "
          f"{np.load(cache, mmap_mode='r').shape if os.path.exists(cache) else 'MISSING'}; "
          f"losses {out['losses']}; optimizer steps on the host clock {out['step_s']} s; grids "
          f"{grids}; peak memory {out['fit']['peak_mem_gib']:.2f} GiB; the trace of step 2: "
          f"{out['trace']} [{card}]", flush=True)
    if not backends or set(backends) != {"native"}:
        fail(f"the LSUN fit read its LMDB through {backends}, not the native scanner")
    if not os.path.exists(cache) or np.load(cache, mmap_mode="r").shape != (
            LSUN_IMAGES, imgsize, imgsize, 3):
        fail(f"the LSUN fit did not write its decode cache {cache}")
    if len(out["losses"]) != LSUN_FIT_STEPS + 1 or not all(np.isfinite(out["losses"])):
        fail(f"the LSUN fits logged the losses {out['losses']}")
    if not grids:
        fail("the LSUN fit's GenerateImage wrote no grid")
    if out["trace"] is None or not all(out["trace"]["launches"].values()):
        fail(f"the LSUN fit's trace does not name K1, K2 and K3: {traces}, {out['trace']}")
    state = CheckpointManager(run).restore(lit.init_state(0, device=dev))
    if state.step != LSUN_FIT_STEPS + 1:
        fail(f"the LSUN run's last checkpoint is at step {state.step}")
    del state
    dm = tcfg.instantiate(config["data"])
    dm.setup("fit")
    torch.cuda.empty_cache()

    # every K1/K3/K4 call of a GenerateImage forward, then every K1/K2/K3
    # call of one microbatch at batch 2, 256 px
    init_weights(lit.model, torch.Generator().manual_seed(SEED))
    randomize_affines(torch, blocks, lit.model, torch.Generator().manual_seed(SEED + 1))
    g = torch.Generator().manual_seed(SEED + 63)
    recorded, _ = record_forwards(torch, blocks, {"lsun_sample": (
        lit.model.to(dev).eval(), torch.randn((n, imgsize, imgsize, 3), generator=g),
        torch.randint(1, timesteps, (n,), generator=g), forward)}, dev)
    rows, failures = forward_rows(torch, k_gn, k_attn, k_res, build, dev, recorded)
    if failures:
        fail(f"the LSUN sampling forward's kernels disagree with their plain versions: {failures}")
    out.update(sample_rows=rows, per_sample_forward=_per_forward(
        rows, "lsun_sample", card, f"LSUN sampling forward at n = {n}"))
    del recorded
    mb = train_kernels(torch, blocks, k_gn, k_attn, None, init_weights, None, dev, card, ops,
                       lit=lit, batch_size=batch_size, sites=calls, img_size=imgsize, dm=dm)
    out.update(rows=mb["shapes"], per_microbatch=mb["per_step"])
    out["remat_peak_gib"] = remat_peaks(torch, blocks, lit, dm, batch_size, imgsize, dev, card,
                                        "LSUN widths")
    algo = lit.diffusion_model
    del lit, dm
    torch.cuda.empty_cache()
    out["gradient"] = train_gradient(
        torch, blocks, init_weights, config_pair(torch, model_node), algo,
        config_draws(torch, np, (LSUN_GRAD_BATCH, LSUN_GRAD_SIZE, LSUN_GRAD_SIZE, 3),
                     algo.timesteps, 1), dev,
        ops, {k: train[k] + forward[k] for k in train}, "LSUN microbatch", forward=True)
    shutil.rmtree(LSUN_ROOT, ignore_errors=True)
    return out


def in64_fit(torch, np, blocks, k_gn, k_attn, k_res, build, init_weights, ops, dev,
             card: str) -> dict:
    """Phase 48: configs/iddpm/imagenet64.yaml on the card through
    ``trainer.main`` as written, its mesh ``{data: -1, fsdp: 1}`` a world of 1
    over NCCL: batch 128, 64 px, 4 heads, the hybrid loss on the cosine
    T = 4000 schedule, remat, ``fused_norm``, on a synthetic
    ``train_data_batch_1.npz`` of ``IN64_ROWS`` channel-planar rows with
    1-based labels: ``IN64_FIT_STEPS`` steps (deterministic cuDNN), the
    backend printed ``nccl``; the same with ``--trainer.mesh null``, the two
    saved states bitwise equal; then ``sample --trainer.sampler
    ddim --trainer.sample_batch 8`` (DDIM-50, ``IN64_BLOCK`` on: K4 at the 30
    ResBlocks); launches as the call sites say, no f32, fp16 or ``simt.cu``
    launch. Every K1/K2/K3 call of a training step at batch 128 and every
    K1/K3/K4 call of a forward at n = 8 held against its plain version, twice
    for identical bytes, and timed beside its bound and library yardstick;
    the bf16 gradient at batch 2 and the forward against the f32 CPU port;
    the step timed with and without the world-1 mesh (whose profiled step
    holds NCCL's all-reduce) and the request timed, with their idle shares."""
    import shutil

    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.parallel import make_mesh, make_train_step, shard_state, shutdown
    from dmme_tpu_torch.training import CheckpointManager
    from dmme_tpu_torch.training.loop import _place

    shutil.rmtree(IN64_ROOT, ignore_errors=True)
    data_dir, run = os.path.join(IN64_ROOT, "data"), os.path.join(IN64_ROOT, "run")
    run_null = os.path.join(IN64_ROOT, "run_null")
    os.makedirs(data_dir)
    rng = np.random.default_rng(SEED + 64)
    np.savez(os.path.join(data_dir, "train_data_batch_1.npz"),
             data=rng.integers(0, 256, (IN64_ROWS, 3 * 64 * 64), np.uint8),
             labels=rng.integers(1, 1001, IN64_ROWS))
    common = ["--config", IN64_CONFIG, "--data.init_args.data_dir", data_dir,
              "--trainer.default_root_dir", run]
    config = tcfg.validate_config(tcfg.apply_overrides(tcfg.load_config(IN64_CONFIG),
                                                       common[2:] + IN64_BLOCK))
    batch_size = config["data"]["init_args"]["batch_size"]
    model_node = config["model"]["init_args"]["model"]
    train, forward, calls = config_sites(torch, blocks, model_node)
    lit = tcfg.instantiate(config["model"])
    print(f"ImageNet-64: {lit.model.__class__.__name__} with "
          f"{sum(p.numel() for p in lit.model.parameters()):,} parameters; launches a training "
          f"step {train}, a sampling forward {forward}", flush=True)
    fit_args = ["--trainer.max_steps", str(IN64_FIT_STEPS), "--trainer.log_every_n_steps", "1"]
    if config["trainer"]["mesh"] != {"data": -1, "fsdp": 1}:
        fail(f"{IN64_CONFIG} names the mesh {config['trainer']['mesh']}")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the two fits compared bit for bit
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = {"fit": cli_run(torch, ops, card, f"ImageNet-64 fit {IN64_FIT_STEPS} steps, the "
                              "config's mesh", ["fit", *common, *fit_args],
                              {k: IN64_FIT_STEPS * v for k, v in train.items()})}
    print(buf.getvalue(), end="", flush=True)
    out["backend"] = [ln for ln in buf.getvalue().splitlines() if ln.startswith("[initialize]")]
    if len(out["backend"]) != 1 or "backend nccl, world 1" not in out["backend"][0]:
        fail(f"the config's mesh did not join a world of 1 over NCCL: {out['backend']}")
    out["fit_null"] = cli_run(torch, ops, card, f"ImageNet-64 fit {IN64_FIT_STEPS} steps, "
                              "--trainer.mesh null",
                              ["fit", "--config", IN64_CONFIG, "--trainer.mesh", "null",
                               "--data.init_args.data_dir", data_dir,
                               "--trainer.default_root_dir", run_null, *fit_args],
                              {k: IN64_FIT_STEPS * v for k, v in train.items()})
    torch.backends.cudnn.deterministic = deterministic
    out["mesh_vs_null"] = state_differences(torch, CheckpointManager(run).load(IN64_FIT_STEPS),
                                            CheckpointManager(run_null).load(IN64_FIT_STEPS))
    print(f"ImageNet-64 with its mesh against --trainer.mesh null: "
          f"{len(out['mesh_vs_null'])} tensors differ", flush=True)
    if out["mesh_vs_null"]:
        fail(f"the world-1 mesh changed the state: {out['mesh_vs_null'][:5]}")
    shutil.rmtree(run_null, ignore_errors=True)
    out["losses"] = [r["loss"] for r in _jsonl(os.path.join(run, "metrics.jsonl"))]
    if len(out["losses"]) != IN64_FIT_STEPS or not all(np.isfinite(out["losses"])):
        fail(f"the ImageNet-64 fit logged the losses {out['losses']}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["sample"] = cli_run(torch, ops, card, "ImageNet-64 sample, DDIM-50 at n = 8",
                                ["sample", *common, *IN64_BLOCK, "--trainer.sampler", "ddim",
                                 "--trainer.sample_batch", str(BATCH)],
                                launches_for(forward, 50))
    print(buf.getvalue(), end="", flush=True)
    grids = [ln for ln in buf.getvalue().splitlines() if ln.endswith("_ddim50.png")]
    if len(grids) != 1 or not os.path.exists(grids[0]):
        fail(f"the ImageNet-64 sample wrote no grid: {grids}")
    print(f"ImageNet-64: losses {out['losses']}; request {out['sample']['wall_s']:.3f} s "
          f"(host clock, with the checkpoint restore) [{card}]", flush=True)

    # the train step and one DDIM-50 request of the trained state, timed
    state = CheckpointManager(run).restore(lit.init_state(0, device=dev))
    dm = tcfg.instantiate(config["data"])
    dm.setup("fit")
    it = dm.train_iter(SEED + 8)
    state, timing, prof3, prof1 = timed_steps(torch, np, make_train_step(lit.make_loss_fn(dm)),
                                              state, lambda: _place(next(it), dev), card)
    out["timing"] = dict(timing, profile_3_steps=prof3, profile_1_step=prof1)
    # the same steps on the config's mesh (a world of 1 over NCCL: the
    # gradients flattened into buckets and all-reduced, the safe point's vote
    # skipped), and one profiled step's host operations
    mesh = make_mesh()
    try:
        mstate = shard_state(CheckpointManager(run).restore(lit.init_state(0, device=dev)), mesh)
        mstep = make_train_step(lit.make_loss_fn(dm), mesh=mesh)
        mstate, mtiming, mprof3, mprof1 = timed_steps(
            torch, np, mstep, mstate, lambda: _place(next(it), dev), card)
        one = _place(next(it), dev)
        names = host_ops(torch, lambda: mstep(mstate, one, SEED))
    finally:
        shutdown()
    del mstate
    out["mesh_timing"] = dict(mtiming, profile_3_steps=mprof3, profile_1_step=mprof1)
    out["mesh_step_ops"] = {n: ms for n, ms in names.items() if "nccl" in n or "allreduce" in n}
    print(f"ImageNet-64 step median: {timing['step_ms_median']:.2f} ms without a mesh, "
          f"{mtiming['step_ms_median']:.2f} ms on the world-1 NCCL mesh; the profiled mesh "
          f"step's collectives (host ms) " + ", ".join(
              f"{n} {ms:.3f}" for n, ms in out["mesh_step_ops"].items()) + f" [{card}]",
          flush=True)
    if "nccl:all_reduce" not in names:
        fail("NCCL's all-reduce is not in a profiled step of the world-1 mesh")
    gen = lambda: lit.generate(state, torch.Generator(device=dev).manual_seed(SEED),  # noqa: E731
                               (BATCH, 64, 64, 3), sampler="ddim", steps=50)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = gen()
    torch.cuda.synchronize()
    out["request_s"] = time.perf_counter() - t0
    out["request_profile"] = prof = profile_fn(torch, gen)
    print(f"ImageNet-64 DDIM-50 at n = {BATCH}: {out['request_s']:.3f} s; profiled: wall "
          f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms in "
          f"{prof['device_ops']} operations, idle share {prof['idle_share']:.3f} [{card}]",
          flush=True)
    if not (y.shape == (BATCH, 64, 64, 3) and bool(y.isfinite().all())):
        fail(f"the ImageNet-64 request gave {tuple(y.shape)}, finite {bool(y.isfinite().all())}")
    del state, y
    k_res._PACKED.clear()
    torch.cuda.empty_cache()

    # every K1/K2/K3 call of a training step at batch 128, and every
    # K1/K3/K4 call of a forward at n = 8 (the sample's)
    step = train_kernels(torch, blocks, k_gn, k_attn, None, init_weights, None, dev, card, ops,
                         lit=lit, batch_size=batch_size, sites=calls, img_size=64, dm=dm)
    out.update(train_rows=step["shapes"], per_step=step["per_step"])
    out["remat_peak_gib"] = remat_peaks(torch, blocks, lit, dm, batch_size, 64, dev, card,
                                        "ImageNet-64 widths")
    model = lit.model.to(dev).eval()  # the seed's weights of train_kernels, K4 on
    g = torch.Generator().manual_seed(SEED + 66)
    runs = {"in64": (model, torch.randn((BATCH, 64, 64, 3), generator=g),
                     torch.randint(1, 4000, (BATCH,), generator=g), forward)}
    reset_counts(ops)
    recorded, _ = record_forwards(torch, blocks, runs, dev)
    torch.cuda.synchronize()
    if counts(ops) != forward:
        fail(f"an ImageNet-64 forward launched {counts(ops)}, expected {forward}")
    frows, failures = forward_rows(torch, k_gn, k_attn, k_res, build, dev, recorded)
    if failures:
        fail(f"ImageNet-64 forward kernels disagree with their plain versions: {failures}")
    out.update(forward_rows=frows,
               per_forward=_per_forward(frows, "in64", card, f"ImageNet-64 forward at n = {BATCH}"))
    algo = lit.diffusion_model
    del model, recorded, lit, dm
    k_res._PACKED.clear()
    torch.cuda.empty_cache()
    out["gradient"] = train_gradient(
        torch, blocks, init_weights, config_pair(torch, model_node), algo,
        config_draws(torch, np, (IN64_BATCH, 64, 64, 3), algo.timesteps, 2), dev, ops,
        {k: train[k] + forward[k] for k in train}, "ImageNet-64 step", forward=True)
    shutil.rmtree(IN64_ROOT, ignore_errors=True)
    return out


def a12_rows(report: dict) -> list:
    """The kernels line's rows of the LSUN and ImageNet-64 paths: K1/K2/K3
    per LSUN microbatch (batch 2, 256 px; launches in the 2-step CLI fit's
    16 microbatches) and K1/K3/K4 per LSUN sampling forward at n = 4 (launches
    in the fit's GenerateImage grid, 100 DDPM forwards), per ImageNet-64
    training step at batch 128 (launches in its 3-step CLI fit) and
    K1/K3/K4 per ImageNet-64 forward at n = 8 (launches in the DDIM-50
    sample)."""
    ls, im = report["lsun_fit"], report["in64_fit"]
    rows = [_table_row(f"{k}_lsun_train", k, ls["per_microbatch"][k], ls["train_launches"][k])
            for k in ("group_norm_silu", "group_norm_silu_bwd", "attention")]
    rows += [_table_row(f"{k}_lsun_sample", k, ls["per_sample_forward"][k],
                        ls["sample_launches"][k])
             for k in ("group_norm_silu", "attention", "resblock")]
    rows += [_table_row(f"{k}_in64_train", k, im["per_step"][k], im["fit"]["launches"][k])
             for k in ("group_norm_silu", "group_norm_silu_bwd", "attention")]
    rows += [_table_row(f"{k}_in64_serve", k, im["per_forward"][k], im["sample"]["launches"][k])
             for k in ("group_norm_silu", "attention", "resblock")]
    return rows


# distribution (A.11): configs/ddpm/cifar10.yaml on two ranks that share the
# card (gloo on CUDA tensors: NCCL refuses two ranks on one device), against
# one process that accumulates two microbatches of half the batch
DIST_ROOT = os.path.join("build", "dist")
DIST_CONFIG = "configs/ddpm/cifar10.yaml"
DIST_RANKS = 2
DIST_STEPS = 3
DIST_BATCH = TRAIN_BATCH // DIST_RANKS  # a rank's slice of the global batch
DIST_TIMED = 2  # timed steps a mesh in each rank
# synthetic CIFAR-10 of a whole number of global batches, so the epoch's
# batches split the same way over ranks and over microbatches
DIST_DATA = ["--data.init_args.synthetic", "true", "--data.init_args.synthetic_size", "1024"]
#: the fsdp run's saved parameters against the data run's, relative L2
DIST_FSDP_REL = 1e-6
#: seconds the two-rank launch may take before its process group is killed
DIST_TIMEOUT = 480
# the expert axis (A.11): the MoE-DiT of MOE_CONFIG on two ranks sharing the
# card, against one process at a rank's batch accumulating DIST_RANKS
EXPERT_MESH = "{data: -1, expert: 2}"
#: a rank's parameters, EMA and Adam moments (f32, 16 B a parameter): the
#: whole model less half of the 56,623,104 elements of the split expert stacks
EXPERT_BYTES, EXPERT_STACKS = 861_310_464, 12
#: a rank's and the accumulating process's losses and grad norms, relative
EXPERT_LOSS_REL = 1e-2
#: one MoE block's dispatch buffer a rank: (E, C, d), C = ⌈64·64·2/8·1.25⌉
EXPERT_A2A = (8, 1280, 384)
# the tensor axis (A.11): the UNet of LSUN_CONFIG column-split over two ranks
# sharing the card, against one process on the same batches without a mesh
TENSOR_MESH = "{data: -1, tensor: 2}"
#: microbatches of batch 2 a step (the config accumulates 32) and steps
TENSOR_ACCUM, TENSOR_STEPS = 2, 1
#: synthetic JPEGs of the tensor fits' LMDB: every microbatch a fresh pair
TENSOR_IMAGES = 2 * TENSOR_ACCUM * TENSOR_STEPS
#: a rank's parameters, EMA and Adam moments (f32, 16 B a parameter):
#: 48,897,667 of the 97,689,219 parameters, 140 kernels split on their
#: output channels, every leaf of 2¹⁴ elements or more among them
TENSOR_BYTES, TENSOR_SPLIT, LSUN_PARAMS = 782_362_672, 140, 97_689_219
#: the mesh run's losses and grad norms against the one process's, relative
TENSOR_LOSS_REL = 1e-2
#: the largest activation a rank all-gathers: its shard of the first up
#: block's concatenation at 256×256, (2, 256, 256, (128 + 128) / 2), bf16
TENSOR_GATHER = (2, 256, 256, 128)
# the tensor axis for the DiT and the MoE-DiT: each config column-split over
# two ranks sharing the card ({data: -1, tensor: 2} on two ranks is one
# tensor group: both ranks take the whole global batch of 128), every
# zero-initialised weight drawn, against one process without a mesh
DIT_TENSOR = {"dit": DIT_CONFIG, "moe": MOE_CONFIG}
DIT_TENSOR_STEPS = 2
#: a rank's parameters, EMA and Adam moments (f32, 16 B a parameter): 65
#: kernels split on their output channels, every leaf of 2¹⁴ elements or
#: more among them (16,285,104 of 32,499,120 and 41,156,832 of 82,143,456)
DIT_TENSOR_BYTES, DIT_TENSOR_SPLIT = {"dit": 260_561_664, "moe": 658_509_312}, 65
#: the largest activation a rank all-gathers, its bf16 shard: a dense
#: block's MLP hidden layer (N, T, 1536 / 2) and a MoE block's experts'
#: (E, C, 1536 / 2), C = ⌈8,192 tokens · 2 / 8 · 1.25⌉
DIT_TENSOR_GATHER = {"dit": (TRAIN_BATCH, 64, 768), "moe": (8, 2560, 768)}


def kernel_counters(k_gn, k_attn, k_res) -> dict:
    """The bf16 launch counters of K1–K4 (``ops``); fills ``WIDE`` with the
    f32, fp16 and ``simt.cu`` ones and those of the split entries (which
    only an H-split fit moves)."""
    WIDE.update({"simt": {"group_norm_silu": (k_gn, "simt_launches"),
                          "group_norm_silu_bwd": (k_gn, "simt_bwd_launches")}})
    WIDE.update({d: {"group_norm_silu": (k_gn, f"{d}_launches"),
                     "group_norm_silu_bwd": (k_gn, f"{d}_bwd_launches"),
                     "attention": (k_attn, f"{d}_launches"),
                     "resblock": (k_res, f"{d}_launches")} for d in ("fp16", "f32")})
    WIDE["split"] = split_counters(k_gn)  # the spatial axis's H-shard entries, every dtype
    return {"group_norm_silu": (k_gn, "launches"), "group_norm_silu_bwd": (k_gn, "bwd_launches"),
            "attention": (k_attn, "launches"), "resblock": (k_res, "launches")}


def state_bytes(state) -> int:
    """Bytes of the parameters, EMA and Adam moments a rank holds."""
    return sum(t.numel() * t.element_size() for part in (
        state.params, state.ema_params, state.opt_state.mu, state.opt_state.nu)
        for t in part.values())


def _dist_fit_argv(root: str, *extra, config: str = DIST_CONFIG, steps: int = DIST_STEPS) -> list:
    return ["fit", "--config", config, *DIST_DATA, "--trainer.max_steps", str(steps),
            "--trainer.log_every_n_steps", "1", "--trainer.callbacks", "[]",
            "--trainer.default_root_dir", root, *extra]


def _tensor_fit_argv(root: str, *extra) -> list:
    """``LSUN_CONFIG`` as phase 47 runs it (K1/K2 on), ``TENSOR_STEPS`` steps
    of ``TENSOR_ACCUM`` microbatches on the LMDB under ``DIST_ROOT/lsun``."""
    return ["fit", "--config", LSUN_CONFIG, *LSUN_KERNELS, "--data.init_args.data_dir",
            os.path.join(DIST_ROOT, "lsun"), "--trainer.accumulate_grad_batches",
            str(TENSOR_ACCUM), "--trainer.max_steps", str(TENSOR_STEPS),
            "--trainer.log_every_n_steps", "1", "--trainer.callbacks", "[]",
            "--trainer.default_root_dir", root, *extra]


@contextlib.contextmanager
def drawn_init(torch):
    """Harnesses' ``init_state`` with every bias, adaLN-Zero kernel and
    expert bias drawn too (:func:`randomize_affines`, seeded): at flax's
    zeros a DiT's MoE branches are gated off and their experts, their
    all-to-alls' backward included, take no gradient."""
    import dmme_tpu_torch.models.blocks as blocks
    from dmme_tpu_torch.training import lit as lit_mod

    original = lit_mod.init_weights

    def init_weights(model, generator):
        original(model, generator)
        randomize_affines(torch, blocks, model, torch.Generator().manual_seed(SEED + 1))

    lit_mod.init_weights = init_weights
    try:
        yield
    finally:
        lit_mod.init_weights = original


@contextlib.contextmanager
def first_gradients(torch, out: dict):
    """``out["grads"]``: the gradients the first ``apply_gradients`` of a run
    receives (on a mesh the reduced ones, the expert and tensor shards
    gathered whole: a collective every rank reaches at the same step)."""
    from dmme_tpu_torch.parallel.mesh import gather_leaves
    from dmme_tpu_torch.training import TrainState

    original = TrainState.apply_gradients

    def apply(state, grads, norm=None):
        if "grads" not in out:
            whole = dict(grads)
            if state.expert_axes:
                whole.update(gather_leaves(state.mesh, whole, state.expert_axes, "expert"))
            if state.tensor_axes:
                whole.update(gather_leaves(state.mesh, whole, state.tensor_axes, "tensor"))
            out["grads"] = {k: v.detach().clone() for k, v in whole.items()}
        return original(state, grads, norm)

    TrainState.apply_gradients = apply
    try:
        yield out
    finally:
        TrainState.apply_gradients = original


def digest(torch, tensors: dict) -> dict:
    """{name: [the sum, a position-weighted sum] of the tensor's 32-bit
    words as int64}: bit-for-bit equal tensors give equal digests."""
    out = {}
    for k, t in tensors.items():
        w = t.detach().contiguous().view(torch.int32).reshape(-1).to(torch.int64)
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        out[k] = [int(w.sum()), int((w * pos).sum())]
    return out


def state_digest(torch, state) -> dict:
    return {"params": digest(torch, state.params), "ema": digest(torch, state.ema_params),
            "mu": digest(torch, state.opt_state.mu), "nu": digest(torch, state.opt_state.nu)}


def dist_timing(torch, dev) -> dict:
    """In a rank: the gradient all-reduce alone (every parameter of
    ``DIST_CONFIG``'s model in f32, flat buckets), host clock, the median
    of ``DIST_TIMED`` after a warm one. (A rank's step: the fits' logged
    steps, :func:`fit_step_ms`.)"""
    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.parallel.mesh import flat_all_reduce

    lit = tcfg.instantiate(tcfg.validate_config(tcfg.load_config(DIST_CONFIG))["model"])
    grads = [torch.zeros(v.shape, device=dev) for v in lit.model.state_dict().values()]
    out = {"allreduce_mb": sum(g.numel() * g.element_size() for g in grads) / 1e6}
    walls = []
    for _ in range(DIST_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat_all_reduce(grads, divisor=float(DIST_RANKS))
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    out["allreduce_ms"] = statistics.median(walls[1:])
    return out


def expert_timing(torch, dev) -> dict:
    """In a rank: the all-to-all alone on one block's ``EXPERT_A2A`` bf16
    dispatch buffer over the ``{data: -1, expert: 2}`` mesh's expert group
    (gloo, handed the CUDA tensors directly, as the layer hands them)."""
    from dmme_tpu_torch.models.moe import ExpertGroup, _exchange
    from dmme_tpu_torch.parallel import make_mesh

    mesh = make_mesh(expert=DIST_RANKS, device=dev)
    where = ExpertGroup(mesh.expert_group, mesh.expert, mesh.index("expert"))
    buf = torch.randn(EXPERT_A2A, device=dev).to(torch.bfloat16)
    a2a = []
    for _ in range(DIST_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _exchange(buf, where)
        torch.cuda.synchronize()
        a2a.append(1e3 * (time.perf_counter() - t0))
    return {"a2a_ms": statistics.median(a2a[1:]),
            "a2a_mb": buf.numel() * buf.element_size() / 1e6,
            "transport": f"{mesh.backend}, direct on CUDA tensors"}


def fit_step_ms(kind: str, images: int = TRAIN_BATCH) -> float:
    """A two-rank fit's step on the host clock (gloo's collectives wait for
    the card): the median of its logged steps after the first, from the
    ``images`` of a global batch and rank 0's ``imgs_per_sec``."""
    rows = _jsonl(os.path.join(DIST_ROOT, kind, "metrics.jsonl"))
    return statistics.median(1e3 * images / r["imgs_per_sec"] for r in rows[1:])


def tensor_timing(torch, dev) -> dict:
    """In a rank: the all-gather of each tensor fit's largest activation
    (the shards ``TENSOR_GATHER`` of the LSUN UNet and ``DIT_TENSOR_GATHER``
    of the DiTs, bf16) over the tensor group, as the models gather them
    (``TensorGroup.gather``: gloo on the CUDA tensors directly), host clock."""
    from dmme_tpu_torch.parallel import make_mesh
    from dmme_tpu_torch.parallel.tensor import TensorGroup

    mesh = make_mesh(tensor=DIST_RANKS, device=dev)
    group = TensorGroup(mesh.tensor_group, mesh.tensor, mesh.index("tensor"))
    out = {}
    for key, shape in (("lsun", TENSOR_GATHER), *DIT_TENSOR_GATHER.items()):
        x = torch.randn(shape, device=dev).to(torch.bfloat16)
        walls = []
        for _ in range(DIST_TIMED + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            whole = group.gather(x)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        out[key] = {"gather_ms": statistics.median(walls[1:]),
                    "gather_mb": whole.numel() * whole.element_size() / 1e6}
    return dict(out.pop("lsun"), **out, transport=f"{mesh.backend}, direct on CUDA tensors")


def k3_held(torch, k_attn, calls) -> float:
    """K3 against its plain version on the first inputs of each recorded
    call site (:func:`record_calls`) within ``TOL``, or fail; the largest
    absolute difference."""
    rtol, atol = TOL["attention"]
    worst = 0.0
    with torch.no_grad():
        for key, _, a, _ in calls["attention"]:
            a = [t.detach() if torch.is_tensor(t) else t for t in a]
            max_abs, _, ok = errors(k_attn.attention_heads(*a),
                                    k_attn.attention_heads_plain(*a), rtol, atol)
            if not ok:
                fail(f"K3 at {key} is {max_abs} from its plain version")
            worst = max(worst, max_abs)
    return worst


@contextlib.contextmanager
def holding(training, held: dict):
    """While open, ``training.fit`` leaves in ``held`` what a command's fit
    leaves its rank holding: the bytes of its parameters, EMA and moments
    and its fsdp-split leaves, and the state itself where the mesh splits a
    leaf on ``expert`` or ``tensor`` or has a ``spatial`` axis (then the
    harness and the data too)."""
    fit = training.fit

    def holding_fit(*args, **kwargs):
        state = fit(*args, **kwargs)
        held.update(state_bytes=state_bytes(state), split_leaves=len(state.shard_axes))
        if state.expert_axes or state.tensor_axes:
            held["state"] = state
        if state.mesh and state.mesh.spatial > 1:
            held.update(state=state, lit=args[0], datamodule=args[1])
        return state

    training.fit = holding_fit
    try:
        yield held
    finally:
        training.fit = fit


def rank_worker(out: str, eval_root: str, pth: str) -> int:
    """One rank of phases 49 and 50 under ``python -m torch.distributed.run
    --standalone --nproc_per_node 2 chip_smoke.py --rank-worker DIR``: the
    kernels loaded from the parent's build, the parent's TF32 and cuDNN
    settings, the group joined once (``parallel.initialize``: gloo, the two
    ranks share the card); then ``trainer.main fit`` on a data=2 and on an
    fsdp=2 mesh, of ``MOE_CONFIG`` on ``EXPERT_MESH`` and of ``LSUN_CONFIG``,
    ``DIT_CONFIG`` and ``MOE_CONFIG`` on ``TENSOR_MESH`` (K3 held against
    its plain version on each DiT rank's own inputs), of ``LSUN_CONFIG`` on
    ``SPATIAL_MESH`` (:func:`spatial_fit`), the all-reduce, the all-to-all,
    the largest activation gathers and the largest halo exchange timed,
    ``trainer.main test`` on a data=2 mesh.
    Each command's launches, and each fit's state bytes, go to
    ``DIR/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    import dmme_tpu_torch.models.blocks as blocks
    from dmme_tpu_torch import training
    from dmme_tpu_torch.ops import attention as k_attn
    from dmme_tpu_torch.ops import build
    from dmme_tpu_torch.ops import group_norm as k_gn
    from dmme_tpu_torch.ops import resblock as k_res
    from dmme_tpu_torch.parallel import initialize, shutdown
    from dmme_tpu_torch.trainer import main as cli

    ops = kernel_counters(k_gn, k_attn, k_res)
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = initialize()
    rank = dist.get_rank()
    rec = {"rank": rank, "backend": dist.get_backend(), "device": str(dev)}
    with holding(training, {}) as held:
        for kind, axis in (("data", "--trainer.mesh.data"), ("fsdp", "--trainer.mesh.fsdp")):
            reset_counts(ops)
            torch.cuda.synchronize()
            t0 = time.time()
            cli(_dist_fit_argv(os.path.join(out, kind), axis, str(DIST_RANKS)))
            torch.cuda.synchronize()
            rec[kind] = dict(held, wall_s=time.time() - t0, launches=counts(ops),
                             wide=wide_counts())
        # the expert axis: the MoE-DiT, its first reduced gradient and its
        # gathered state kept for the checks here and in the parent
        first = {}
        with drawn_init(torch), first_gradients(torch, first):
            reset_counts(ops)
            torch.cuda.synchronize()
            t0 = time.time()
            cli(_dist_fit_argv(os.path.join(out, "expert"), "--trainer.mesh", EXPERT_MESH,
                               config=MOE_CONFIG))
            torch.cuda.synchronize()
            state = held.pop("state")
            rec["expert"] = dict(held, wall_s=time.time() - t0, launches=counts(ops),
                                 wide=wide_counts(), split_leaves=len(state.expert_axes))
        whole = state.whole()  # a collective: both ranks
        if rank == 0:
            rec["expert"]["digest"] = state_digest(torch, whole)
            rec["expert"]["params"] = sum(v.numel() for v in whole.params.values())
            want = torch.load(os.path.join(out, "moe_one_grads.pt"), map_location=dev)
            rec["expert"]["grad_rel"] = _rel_l2(torch, want, first["grads"])
        del state, whole, first
        torch.cuda.empty_cache()
        # the tensor axis: the LSUN UNet column-split over both ranks, its
        # first reduced gradient, its gathered state, its peak and the call
        # sites of K1, K2 and K3 on the shards kept for the checks in the parent
        first, peaks = {}, {}
        with drawn_init(torch), first_gradients(torch, first):
            reset_counts(ops)
            torch.cuda.synchronize()
            t0 = time.time()
            with step_peaks(torch, peaks):
                calls = record_calls(train_targets(blocks, k_gn, k_attn), lambda: cli(
                    _tensor_fit_argv(os.path.join(out, "tensor"), "--trainer.mesh",
                                     TENSOR_MESH)), inputs=False)
            torch.cuda.synchronize()
            state = held.pop("state")
            rec["tensor"] = dict(held, wall_s=time.time() - t0, launches=counts(ops),
                                 wide=wide_counts(), split_leaves=len(state.tensor_axes),
                                 peak_bytes=peaks["fwd_bwd"],
                                 sites={kind: {repr(key): n for key, n, _, _ in v}
                                        for kind, v in calls.items()})
        del calls
        whole = state.whole()  # a collective: both ranks
        if rank == 0:
            rec["tensor"]["digest"] = state_digest(torch, whole)
            rec["tensor"]["params"] = sum(v.numel() for v in whole.params.values())
            want = torch.load(os.path.join(out, "tensor_one_grads.pt"), map_location=dev)
            rec["tensor"]["grad_rel"] = _rel_l2(torch, want, first["grads"])
        del state, whole, first
        torch.cuda.empty_cache()
        # the spatial axis: the LSUN UNet H-split over both ranks on the same
        # batches and draws, the tensor fit's one process its reference
        rec["spatial"] = spatial_fit(torch, blocks, k_gn, k_attn, ops, cli, held, out, dev, rank)
        rec.update(dit_tensor_fits(torch, k_attn, ops, cli, held, out, dev, rank))
    rec["timing"] = dist_timing(torch, dev)
    rec["timing"]["expert"] = expert_timing(torch, dev)
    rec["timing"]["tensor"] = tensor_timing(torch, dev)
    rec["timing"]["spatial"] = spatial_timing(torch, dev, rec["spatial"]["traffic"]["largest_halo"])
    reset_counts(ops)
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        cli(["test", "--config", DDIM_CONFIG, *EVAL_DATA, "--trainer.default_root_dir", eval_root,
             "--trainer.limit_test_batches", str(EVAL_BATCHES), "--trainer.inception_weights",
             pth, "--trainer.mesh.data", str(DIST_RANKS)])
    torch.cuda.synchronize()
    rec["test"] = {"wall_s": time.time() - t0, "launches": counts(ops), "wide": wide_counts(),
                   "printed": buf.getvalue()}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    shutdown()
    return 0


# the spatial axis (A.11): the UNet of LSUN_CONFIG H-split over two ranks
# sharing the card ({data: -1, spatial: 2} on two ranks is one spatial
# group: both take the whole batch and draw as one batch rank), on the
# tensor fit's batches, so the tensor fit's one process is its reference
SPATIAL_MESH = "{data: -1, spatial: 2}"
#: the split entries of K1 and K2 on an H-shard, in launch order
#: (``ops/group_norm.py:SPLIT_ENTRIES``), and the kernel each one splits
SPLIT_KERNEL = {"sums": "group_norm_silu", "apply": "group_norm_silu",
                "bwd_sums": "group_norm_silu_bwd", "bwd_dx": "group_norm_silu_bwd"}
#: the fp16 and f32 shape the split entries are held at beside the bf16
#: lsun_church levels: (N, H, W, C) of a whole sample, split in two along H
SPLIT_WIDE_SHAPE = (2, 32, 32, 256)
SPLIT_GROUPS = 32
# the spatial axis composed (A.11): four ranks sharing the card, launched
# after the two-rank phase on its files under DIST_ROOT. The UNet of
# LSUN_CONFIG on COMPOSED_MESH (spatial groups {0, 1} and {2, 3}, tensor
# groups {0, 2} and {1, 3}: one batch slice), against the tensor fit's one
# process; the UNet of DIST_CONFIG on EXPERT_SPATIAL_MESH (the expert axis
# splits no UNet leaf: two batch ranks of two spatial ranks), against the
# data fit's one process accumulating 2
QUAD_RANKS = 4
COMPOSED_MESH = "{data: -1, tensor: 2, spatial: 2}"
EXPERT_SPATIAL_MESH = "{data: -1, expert: 2, spatial: 2}"
#: the expert x spatial run's saved parameters and EMA against the one
#: process's, relative L2
EXPERT_SPATIAL_REL = 1e-5
#: seconds the four-rank launch may take before its process group is killed
QUAD_TIMEOUT = 420


def split_counters(k_gn) -> dict:
    """{entry: (module, counter)} of the split entries' launches in every
    dtype (``fp16_`` and ``f32_`` prefixed names for the wide ones)."""
    return {f"{p}{e}": (k_gn, f"{p}{e}_launches") for p in ("", "fp16_", "f32_")
            for e in SPLIT_KERNEL}


def lsun_gn_sites(torch, blocks) -> list:
    """The distinct K1 call sites (whole (N, H, W, C), pre-bias or not) of a
    training microbatch of ``LSUN_CONFIG``'s UNet at batch 2 with
    ``fused_norm``, from one forward on the meta device."""
    from dmme_tpu_torch import config as tcfg

    config = tcfg.validate_config(tcfg.apply_overrides(tcfg.load_config(LSUN_CONFIG),
                                                       LSUN_KERNELS))
    node = config["model"]["init_args"]["model"]
    seen = set()

    def gn(x, gamma, beta, groups, eps=None, pre_bias=None):
        seen.add((tuple(x.shape), pre_bias is not None))
        return torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)

    def attention(q, k, v, scale, *rest):
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)

    saved = blocks.group_norm_silu, blocks.attention_heads
    try:
        blocks.group_norm_silu, blocks.attention_heads = gn, attention
        with torch.device("meta"), torch.no_grad():
            model = tcfg.instantiate(dict(node, init_args=dict(node["init_args"],
                                                               fused_block=False)))
            model.eval()(torch.empty((2, LSUN_IMG, LSUN_IMG, 3)),
                         torch.zeros((2,), dtype=torch.int64))
    finally:
        blocks.group_norm_silu, blocks.attention_heads = saved
    return sorted(seen)


def _split_bytes(entry: str, x, groups: int, pre: bool) -> tuple:
    """(bytes, f32 operations) of one split entry on the shard ``x``: each
    input read once and each output written once (x, dz, dx and y in x's
    dtype; the (N, 2C) sums, the (C,) affines, the (N, C) pre-bias and the
    (N, G) statistics in f32)."""
    n, _, _, c = x.shape
    act, sums, vecs = x.numel() * x.element_size(), 2 * n * c * 4, 2 * c * 4 + (
        n * c * 4 if pre else 0)
    stats = 2 * n * groups * 4
    return {"sums": (act + sums, 3 * x.numel()),
            "apply": (2 * act + sums + vecs + stats, 10 * x.numel()),
            "bwd_sums": (2 * act + vecs + stats + sums, 15 * x.numel()),
            "bwd_dx": (3 * act + vecs + stats + sums + n * c * 4, 20 * x.numel())}[entry]


def _plain_apply(k_gn):
    """``gn_silu_apply_plain`` taking the split ``apply`` wrapper's arguments
    (x, sums, γ, β, groups, pixels, eps, pre-bias)."""
    return lambda x, sums, gamma, beta, groups, pixels, eps, pre: k_gn.gn_silu_apply_plain(
        x, sums, gamma, beta, pre, groups, pixels, eps)


def split_kernels(torch, blocks, k_gn, dev, card: str) -> dict:
    """Phase 3's split entries (the spatial axis's K1 and K2 on H-shards):
    at every K1 site of an ``LSUN_CONFIG`` microbatch at batch 2 in bf16,
    at each such site's channel shard of a tensor rank (C/2 channels in G/2
    groups: a composed rank's shard, split in two along H), and at
    ``SPLIT_WIDE_SHAPE`` in fp16 and f32, a sample's rows split in two:
    ``sums`` on each half, the two added on the card, ``apply`` on each
    half; K2's pair likewise from K1's statistics. Each held against its
    plain version and against the one-call K1/K2 on the whole tensor under
    ``TOL`` (``_gn_errors``), each entry's counter moved twice a case and
    the others not, repeat-identical bytes; the bf16 entries timed on a
    half (a rank's shard) beside their plain versions and bounds, once a
    shard shape and group count (with its pre-bias where it has one).
    Returns {"rows": one a case and entry}."""
    F = torch.float32
    sites = lsun_gn_sites(torch, blocks)
    cases = [(shape, pre, torch.bfloat16, SPLIT_GROUPS) for shape, pre in sites]
    cases += [((*shape[:3], shape[3] // DIST_RANKS), pre, torch.bfloat16,
               SPLIT_GROUPS // DIST_RANKS) for shape, pre in sites]
    cases += [(SPLIT_WIDE_SHAPE, True, dt, SPLIT_GROUPS) for dt in (torch.float16, torch.float32)]
    with_pre = {(shape, groups) for shape, pre, _, groups in cases if pre}
    counters = split_counters(k_gn)
    rows, failures = [], []
    for shape, pre, dt, groups in cases:
        g = torch.Generator(device=dev).manual_seed(SEED + shape[1] + shape[3])
        n, h, w, c = shape
        x = torch.randn(shape, generator=g, device=dev).to(dt)
        dz = torch.randn(shape, generator=g, device=dev).to(dt)
        gamma = 1.0 + 0.1 * torch.randn(c, generator=g, device=dev)
        beta = 0.1 * torch.randn(c, generator=g, device=dev)
        bias = 0.1 * torch.randn((n, c), generator=g, device=dev) if pre else None
        halves = [t.contiguous() for t in x.chunk(2, dim=1)]
        dzs = [t.contiguous() for t in dz.chunk(2, dim=1)]
        pixels = h * w
        with torch.no_grad():
            for _, attr in counters.values():
                setattr(k_gn, attr, 0)

            def fwd(sums_fn, apply_fn):
                s = sums_fn(halves[0]) + sums_fn(halves[1])
                outs = [apply_fn(t, s, gamma, beta, groups, pixels, k_gn.GN_EPS, bias)
                        for t in halves]
                return (torch.cat([o[0] for o in outs], 1), outs[0][1], outs[0][2]), outs

            def bwd(sums_fn, dx_fn, mean, inv):
                mine = [sums_fn(t, d, gamma, beta, bias, mean, inv, groups)
                        for t, d in zip(halves, dzs)]
                total = mine[0] + mine[1]
                outs = [dx_fn(t, d, gamma, beta, bias, mean, inv, total, groups, pixels)
                        for t, d in zip(halves, dzs)]
                return (torch.cat([o[0] for o in outs], 1), total[:, c:], total[:, :c],
                        outs[0][1] + outs[1][1])

            got, outs = fwd(k_gn.group_norm_silu_sums, k_gn.group_norm_silu_apply)
            want_plain, _ = fwd(k_gn.gn_silu_sums_plain, _plain_apply(k_gn))
            one = k_gn.group_norm_silu_fwd(x, gamma, beta, groups, k_gn.GN_EPS, bias)
            same_stats = bool(torch.equal(outs[0][1], outs[1][1])
                              and torch.equal(outs[0][2], outs[1][2]))
            mean, inv = one[1], one[2]
            gotb = bwd(k_gn.group_norm_silu_bwd_sums, k_gn.group_norm_silu_bwd_dx, mean, inv)
            want_plain_b = bwd(k_gn.gn_silu_bwd_sums_plain, k_gn.gn_silu_bwd_dx_plain, mean, inv)
            one_b = k_gn.group_norm_silu_bwd(x, dz, gamma, beta, bias, mean, inv, groups)
            again = fwd(k_gn.group_norm_silu_sums, k_gn.group_norm_silu_apply)[0]
            againb = bwd(k_gn.group_norm_silu_bwd_sums, k_gn.group_norm_silu_bwd_dx, mean, inv)
            torch.cuda.synchronize()
        prefix = {torch.bfloat16: "", torch.float16: "fp16_", torch.float32: "f32_"}[dt]
        moved = {k: getattr(m, a) for k, (m, a) in counters.items()}
        want_moved = {k: 4 if k in {prefix + e for e in SPLIT_KERNEL} else 0 for k in counters}
        e_plain, ok_plain = _gn_errors(got, want_plain)
        e_one, ok_one = _gn_errors(got, one)
        eb_plain, okb_plain = _gn_errors(gotb, want_plain_b)
        eb_one, okb_one = _gn_errors(gotb, one_b)
        same = all(bool(torch.equal(a, b)) for a, b in zip(got + gotb, again + againb))
        ok = (ok_plain and ok_one and okb_plain and okb_one and same and same_stats
              and moved == want_moved)
        key = f"{tuple(shape)} {str(dt)[6:]} G {groups} pre_bias {pre}"
        print(f"split K1/K2 at {key}: K1 pair max_abs {e_plain:.3e} vs plain, {e_one:.3e} vs "
              f"one-call K1; K2 pair {eb_plain:.3e} vs plain, {eb_one:.3e} vs one-call K2; "
              f"repeat {'identical' if same else 'DIFFERENT'}; counters {moved}"
              + ("" if ok else "  FAIL"), flush=True)
        if not ok:
            failures.append(key)
        row = {"shape": list(shape), "groups": groups, "dtype": str(dt), "pre_bias": pre,
               "max_abs_err": max(e_plain, e_one, eb_plain, eb_one), "ok": ok}
        if dt == torch.bfloat16 and (pre or (shape, groups) not in with_pre):
            # each entry timed on a half (a rank's shard), once a shard shape
            t, d = halves[0], dzs[0]
            s = k_gn.group_norm_silu_sums(halves[0]) + k_gn.group_norm_silu_sums(halves[1])
            sb = k_gn.group_norm_silu_bwd_sums(t, d, gamma, beta, bias, mean, inv, groups)
            calls = {
                "sums": (lambda: k_gn.group_norm_silu_sums(t),
                         lambda: k_gn.gn_silu_sums_plain(t)),
                "apply": (lambda: k_gn.group_norm_silu_apply(t, s, gamma, beta, groups,
                                                             pixels, k_gn.GN_EPS, bias),
                          lambda: _plain_apply(k_gn)(t, s, gamma, beta, groups, pixels,
                                                     k_gn.GN_EPS, bias)),
                "bwd_sums": (lambda: k_gn.group_norm_silu_bwd_sums(
                    t, d, gamma, beta, bias, mean, inv, groups),
                    lambda: k_gn.gn_silu_bwd_sums_plain(t, d, gamma, beta, bias, mean, inv,
                                                        groups)),
                "bwd_dx": (lambda: k_gn.group_norm_silu_bwd_dx(
                    t, d, gamma, beta, bias, mean, inv, sb, groups, pixels),
                    lambda: k_gn.gn_silu_bwd_dx_plain(t, d, gamma, beta, bias, mean, inv, sb,
                                                      groups, pixels))}
            with torch.no_grad():
                for entry, (kern, plain) in calls.items():
                    nbytes, ops_ = _split_bytes(entry, t, groups, pre)
                    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / F32_FLOPS
                    row[entry] = {"ms": device_ms(torch, kern),
                                  "plain_ms": device_ms(torch, plain, reps=PLAIN_REPS,
                                                        warm=PLAIN_WARM),
                                  "bound_ms": 1e3 * max(t_bytes, t_ops),
                                  "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
            print(f"    on a rank's shard {tuple(t.shape)}: " + "; ".join(
                f"{e} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, bound {v['bound_ms']:.4f} "
                f"{v['bound_by']})" for e, v in row.items() if e in SPLIT_KERNEL)
                + f" [{card}]", flush=True)
        del x, dz, halves, dzs, got, gotb, want_plain, want_plain_b, one, one_b, again, againb
        rows.append(row)
    print(f"split entries held against their plain versions and the one-call K1/K2: tolerances "
          f"K1 {TOL['group_norm_silu']}, K2 dx {TOL_BWD['dx']} and sums {TOL_BWD['vec']}, f32 "
          f"and fp16 {TOL_SIMT}", flush=True)
    for _, attr in counters.values():
        setattr(k_gn, attr, 0)
    if failures:
        fail(f"the split K1/K2 entries disagree at {failures}")
    return {"rows": rows}


def _sig_sums(x):
    return (tuple(x.shape),)


def _sig_apply(x, sums, gamma, beta, groups, pixels, eps=None, pre_bias=None):
    return (tuple(x.shape), pre_bias is not None)


def _sig_split_bwd(x, dz, gamma, beta, pre_bias, *rest):
    return (tuple(x.shape), pre_bias is not None)


def split_targets(k_gn, blocks):
    """The four split entries, as the autograd Function of an H-split
    GN+SiLU reaches them (a call site: the shard's shape, and whether it
    has a pre-bias), and K3 (whole on every rank)."""
    sigs = {"sums": _sig_sums, "apply": _sig_apply, "bwd_sums": _sig_split_bwd,
            "bwd_dx": _sig_split_bwd}
    return [(k_gn, f"group_norm_silu_{e}", e, sigs[e]) for e in SPLIT_KERNEL] + [
        (blocks, "attention_heads", "attention", _sig_attn)]


def split_held(torch, k_gn, calls) -> dict:
    """In a rank: each split entry again on the first inputs of each of its
    recorded call sites (:func:`record_calls`) against its plain version:
    y within ``TOL``, the sums and dx within ``TOL_BWD`` (``_gn_errors``), or
    fail. {entry: the largest absolute difference}."""
    plain = {"sums": k_gn.gn_silu_sums_plain, "apply": _plain_apply(k_gn),
             "bwd_sums": k_gn.gn_silu_bwd_sums_plain, "bwd_dx": k_gn.gn_silu_bwd_dx_plain}
    out = {}
    with torch.no_grad():
        for entry in SPLIT_KERNEL:
            worst = 0.0
            for key, _, a, k in calls[entry]:
                a = [t.detach() if torch.is_tensor(t) else t for t in a]
                got = getattr(k_gn, f"group_norm_silu_{entry}")(*a, **k)
                want = plain[entry](*a, **k)
                if torch.is_tensor(got):  # the (N, 2C) sums
                    e, _, ok = scaled_errors(got, want, *TOL_BWD["vec"])
                else:
                    e, ok = _gn_errors(tuple(got), tuple(want))
                if not ok:
                    fail(f"the split entry {entry} at {key} is {e} from its plain version")
                worst = max(worst, e)
            out[entry] = worst
    return out


@contextlib.contextmanager
def spatial_traffic(torch):
    """Counts of the spatial group's collectives while open: halo exchanges
    (each an all-gather of every rank's two edge rows: forward and
    backward), the statistics' all-reduces and the row gathers, and the
    largest halo exchange's edge rows (shape, dtype)."""
    from dmme_tpu_torch.parallel import spatial as sp

    got = {"halos": 0, "all_reduces": 0, "gathers": 0, "largest_halo": None}
    edges, reduce_, gather = sp._edges, sp.SpatialGroup.reduce_, sp._all_gather_rows

    def counted_edges(a, b, where):
        got["halos"] += 1
        big = got["largest_halo"]
        if big is None or a.numel() > math.prod(big[0]):
            got["largest_halo"] = (list(a.shape), str(a.dtype))
        return edges(a, b, where)

    def counted_reduce(self, t):
        got["all_reduces"] += 1
        return reduce_(self, t)

    def counted_gather(x, where):
        got["gathers"] += 1
        return gather(x, where)

    sp._edges, sp.SpatialGroup.reduce_, sp._all_gather_rows = (counted_edges, counted_reduce,
                                                                counted_gather)
    try:
        yield got
    finally:
        sp._edges, sp.SpatialGroup.reduce_, sp._all_gather_rows = edges, reduce_, gather


@contextlib.contextmanager
def tensor_traffic(torch):
    """Counts of the tensor group's collectives while open: the channel
    all-gathers (forward; ``TensorGroup.gather``, ``gather_cat``) and their
    reduce-scatters (backward), and the largest all-gather's shard (shape,
    dtype)."""
    from dmme_tpu_torch.parallel import tensor as tp

    got = {"channel_gathers": 0, "channel_scatters": 0, "largest_gather": None}
    gather, scatter = tp._all_gather, tp._reduce_scatter

    def counted_gather(x, where):
        got["channel_gathers"] += 1
        big = got["largest_gather"]
        if big is None or x.numel() > math.prod(big[0]):
            got["largest_gather"] = (list(x.shape), str(x.dtype))
        return gather(x, where)

    def counted_scatter(g, where):
        got["channel_scatters"] += 1
        return scatter(g, where)

    tp._all_gather, tp._reduce_scatter = counted_gather, counted_scatter
    try:
        yield got
    finally:
        tp._all_gather, tp._reduce_scatter = gather, scatter


@contextlib.contextmanager
def step_peaks(torch, out: dict):
    """``out["fwd_bwd"]``: the device memory allocated at its peak, less
    ``out["base"]``, as each ``TrainState.apply_gradients`` starts (the
    microbatches' forwards and backwards and their accumulated gradients,
    before the optimizer's temporaries), the largest over a run's steps;
    ``out["fit"]`` the same over the whole run, read when it closes."""
    from dmme_tpu_torch.training import TrainState

    original = TrainState.apply_gradients

    def apply(state, grads, norm=None):
        torch.cuda.synchronize()
        out["fwd_bwd"] = max(out.get("fwd_bwd", 0),
                             torch.cuda.max_memory_allocated() - out["base"])
        return original(state, grads, norm)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["base"] = torch.cuda.memory_allocated()
    TrainState.apply_gradients = apply
    try:
        yield out
    finally:
        TrainState.apply_gradients = original
        torch.cuda.synchronize()
        out["fit"] = torch.cuda.max_memory_allocated() - out["base"]


def spatial_fit(torch, blocks, k_gn, k_attn, ops, cli, held: dict, out: str, dev,
                rank: int, tag: str = "spatial", mesh: str = SPATIAL_MESH) -> dict:
    """In a rank: ``trainer.main fit`` (``cli``) of ``LSUN_CONFIG`` on
    ``mesh`` (``SPATIAL_MESH``, or ``COMPOSED_MESH`` with ``tensor``), into
    ``<out>/<tag>``, on the tensor fit's batches with every bias drawn: its
    wall time, launches (the split counters among the wide ones), its peak
    memory (:func:`step_peaks`), the call sites of the split entries and of
    K3, the collectives of the spatial and tensor groups, the digest of the
    state the rank holds and (a collective where a leaf is split) of the
    gathered one; on rank 0 its first reduced gradient against the one
    process's (``<out>/tensor_one_grads.pt``). Then one more microbatch of
    the fitted model on every rank, its call sites recorded (the fit records
    no inputs, which its peak would hold) and each split entry and K3 held
    against its plain version on this rank's inputs."""
    first, peaks = {}, {}
    with (drawn_init(torch), first_gradients(torch, first), spatial_traffic(torch) as traffic,
          tensor_traffic(torch) as gathers):
        reset_counts(ops)
        t0 = time.time()
        with step_peaks(torch, peaks):
            calls = record_calls(split_targets(k_gn, blocks), lambda: cli(
                _tensor_fit_argv(os.path.join(out, tag), "--trainer.mesh", mesh)), inputs=False)
        wall = time.time() - t0
        state = held.pop("state")
    lit, dm = held.pop("lit"), held.pop("datamodule")
    whole = state.whole()  # a collective where a leaf is split: every rank
    rec = dict(held, wall_s=wall, peak_bytes=peaks["fwd_bwd"], fit_peak_bytes=peaks["fit"],
               launches=counts(ops), wide=wide_counts(), traffic=dict(traffic, **gathers),
               digest=state_digest(torch, state), whole_digest=state_digest(torch, whole),
               params=sum(v.numel() for v in whole.params.values()),
               tensor_split=len(state.tensor_axes),
               sites={kind: {repr(key): n for key, n, _, _ in v} for kind, v in calls.items()})
    del whole
    if rank == 0:
        want = torch.load(os.path.join(out, "tensor_one_grads.pt"), map_location=dev)
        rec["grad_rel"] = _rel_l2(torch, want, first["grads"])
    del first
    # one more microbatch on every rank (the spatial and tensor groups share its batch)
    params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    batch = torch.randint(0, 256, (2, LSUN_IMG, LSUN_IMG, 3), dtype=torch.uint8, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED))
    loss_fn = lit.make_loss_fn(dm)

    def microbatch():
        loss = loss_fn(params, torch.Generator(device=dev).manual_seed(SEED), batch)
        torch.autograd.grad(loss, list(params.values()))

    calls = record_calls(split_targets(k_gn, blocks), microbatch)
    rec.update(split_max_abs=split_held(torch, k_gn, calls),
               k3_max_abs=k3_held(torch, k_attn, calls))
    del state, params, calls, lit, dm
    torch.cuda.empty_cache()
    return rec


def spatial_timing(torch, dev, largest) -> dict:
    """In a rank: the halo exchange of the spatial fit's largest edge rows
    (``largest``: their shape and dtype) over the spatial group, as the
    model exchanges them (gloo on the CUDA tensors directly), host clock,
    the median of ``DIST_TIMED`` after a warm one."""
    from dmme_tpu_torch.parallel import make_mesh
    from dmme_tpu_torch.parallel.spatial import SpatialGroup, _edges

    mesh = make_mesh(spatial=DIST_RANKS, device=dev)
    where = SpatialGroup(mesh.spatial_group, mesh.spatial, mesh.index("spatial"))
    shape, dtype = largest
    a = torch.randn(shape, device=dev).to(getattr(torch, dtype.removeprefix("torch.")))
    walls = []
    for _ in range(DIST_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _edges(a, a, where)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return {"halo_ms": statistics.median(walls[1:]), "halo_shape": shape,
            "halo_kb": 2 * DIST_RANKS * a.numel() * a.element_size() / 1e3,
            "transport": f"{mesh.backend}, direct on CUDA tensors"}


def quad_worker(out: str) -> int:
    """One rank of the four-rank launch under ``python -m
    torch.distributed.run --standalone --nproc_per_node 4 chip_smoke.py
    --quad-worker DIR``: the kernels loaded from the parent's build, the
    parent's TF32 and cuDNN settings, the group joined once (gloo, the four
    ranks share the card); then ``trainer.main fit`` of ``LSUN_CONFIG`` on
    ``COMPOSED_MESH`` (:func:`spatial_fit`) and of ``DIST_CONFIG`` on
    ``EXPERT_SPATIAL_MESH``, and the largest halo exchange and channel
    all-gather of the composed fit timed. Each fit's record goes to
    ``DIR/quad<r>.json``."""
    import torch
    import torch.distributed as dist

    import dmme_tpu_torch.models.blocks as blocks
    from dmme_tpu_torch import training
    from dmme_tpu_torch.ops import attention as k_attn
    from dmme_tpu_torch.ops import build
    from dmme_tpu_torch.ops import group_norm as k_gn
    from dmme_tpu_torch.ops import resblock as k_res
    from dmme_tpu_torch.parallel import initialize, shutdown
    from dmme_tpu_torch.trainer import main as cli

    ops = kernel_counters(k_gn, k_attn, k_res)
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = initialize()
    rank = dist.get_rank()
    rec = {"rank": rank, "backend": dist.get_backend(), "device": str(dev)}
    with holding(training, {}) as held:
        rec["composed"] = spatial_fit(torch, blocks, k_gn, k_attn, ops, cli, held, out, dev, rank,
                                      tag="composed", mesh=COMPOSED_MESH)
        reset_counts(ops)
        torch.cuda.synchronize()
        t0 = time.time()
        cli(_dist_fit_argv(os.path.join(out, "expert_spatial"), "--trainer.mesh",
                           EXPERT_SPATIAL_MESH))
        torch.cuda.synchronize()
        state = held.pop("state")
        del held["lit"], held["datamodule"]
        rec["expert_spatial"] = dict(held, wall_s=time.time() - t0, launches=counts(ops),
                                     wide=wide_counts(), digest=state_digest(torch, state))
        del state
    rec["timing"] = composed_timing(torch, dev, rec["composed"]["traffic"])
    with open(os.path.join(out, f"quad{rank}.json"), "w") as f:
        json.dump(rec, f)
    shutdown()
    return 0


def composed_timing(torch, dev, traffic: dict) -> dict:
    """In a rank of the four-rank launch: the composed fit's largest halo
    exchange over its spatial group and its largest channel all-gather over
    its tensor group (``traffic``: their shapes and dtypes), as the model
    makes them (gloo on the CUDA tensors directly), host clock, the median
    of ``DIST_TIMED`` after a warm one."""
    from dmme_tpu_torch.parallel import make_mesh
    from dmme_tpu_torch.parallel.spatial import SpatialGroup, _edges
    from dmme_tpu_torch.parallel.tensor import TensorGroup

    mesh = make_mesh(tensor=2, spatial=2, device=dev)
    where = SpatialGroup(mesh.spatial_group, mesh.spatial, mesh.index("spatial"))
    group = TensorGroup(mesh.tensor_group, mesh.tensor, mesh.index("tensor"))
    out = {"transport": f"{mesh.backend}, direct on CUDA tensors"}
    for key, (shape, dtype), run in (("halo", traffic["largest_halo"], lambda a: _edges(a, a, where)),
                                     ("gather", traffic["largest_gather"], group.gather)):
        a = torch.randn(shape, device=dev).to(getattr(torch, dtype.removeprefix("torch.")))
        walls = []
        for _ in range(DIST_TIMED + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(a)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        size = 2 * mesh.spatial if key == "halo" else mesh.tensor
        out.update({f"{key}_ms": statistics.median(walls[1:]), f"{key}_shape": shape,
                    f"{key}_kb": size * a.numel() * a.element_size() / 1e3})
    return out


def _halved_sites(sites: dict) -> dict:
    """A spatial rank's split-entry call sites (``repr`` of (shape, …)) at a
    tensor rank's channel shard: the shape's C halved."""
    out = {}
    for key, n in sites.items():
        shape, *rest = ast.literal_eval(key)
        out[repr((tuple(shape[:3]) + (shape[3] // DIST_RANKS,), *rest))] = n
    return out


def launch_ranks(cmd: list, log_path: str, timeout: float, what: str) -> float:
    """Run the ``torch.distributed.run`` command ``cmd`` in its own session,
    its output to ``log_path`` (the last lines printed), killed with its
    ranks at ``timeout``; fail unless it ends with 0. Returns its wall
    seconds."""
    t0 = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)  # the launcher and its ranks
            proc.wait()
            rc = None
    wall = time.time() - t0
    with open(log_path) as f:
        lines = [ln for ln in f.read().splitlines() if not ln.startswith("[W")]
    print("\n".join(lines[-40:]), flush=True)
    if rc != 0:
        fail(f"the {what} launch ended with {rc} after {wall:.1f} s")
    return wall


def quad_phase(torch, dist_out: dict, card: str) -> dict:
    """The four-rank launch (:func:`quad_worker`) and its checks. The
    composed fit against the tensor fit's one process
    (``dist_out["tensor_one"]``, the same batches and draws): each rank's
    launches the split entries at the spatial rank's call sites with C
    halved (C/2 channels in G/2 groups) and the one process's counts, K3 at
    the spatial rank's sites, nothing of the one-call K1/K2, f32, fp16 or
    ``simt.cu``; its split entries and K3 held on its own inputs; its bytes
    ``TENSOR_BYTES`` in ``TENSOR_SPLIT`` split kernels; the losses and grad
    norms within ``TENSOR_LOSS_REL``, the first reduced gradient within
    ``GRAD_REL_L2``; the ranks of each spatial group bitwise equal, every
    rank's gathered state alike and the checkpoint restored without a mesh
    bitwise it. The expert x spatial fit against the data fit's one process
    accumulating 2 (``DIST_ROOT/one``): the saved parameters and EMA within
    ``EXPERT_SPATIAL_REL``, the losses and grad norms within
    ``EXPERT_LOSS_REL``, every rank's state bitwise equal and the checkpoint
    bitwise it, each rank's launches the split entries at a batch-64 step's
    counts. Prints the collectives a microbatch, a rank's step, the largest
    halo and channel all-gather timed and the peaks beside the spatial and
    tensor ranks'."""
    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.training import CheckpointManager

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(QUAD_RANKS), os.path.abspath(__file__), "--quad-worker", DIST_ROOT]
    out = {"launch_wall_s": launch_ranks(cmd, os.path.join(DIST_ROOT, "torchrun_quad.log"),
                                         QUAD_TIMEOUT, "four-rank")}
    ranks = []
    for r in range(QUAD_RANKS):
        with open(os.path.join(DIST_ROOT, f"quad{r}.json")) as f:
            ranks.append(json.load(f))
    out["ranks"] = ranks
    if {r["backend"] for r in ranks} != {"gloo"}:
        fail(f"four ranks on one card joined over {[r['backend'] for r in ranks]}, not gloo")

    # the composed fit
    one, pair = dist_out["tensor_one"], dist_out["ranks"]
    want = dict(one["launches"], group_norm_silu=0, group_norm_silu_bwd=0)
    want_split = {"sums": one["launches"]["group_norm_silu"],
                  "apply": one["launches"]["group_norm_silu"],
                  "bwd_sums": one["launches"]["group_norm_silu_bwd"],
                  "bwd_dx": one["launches"]["group_norm_silu_bwd"]}
    spatial_sites = pair[0]["spatial"]["sites"]
    want_sites = {e: _halved_sites(spatial_sites[e]) for e in SPLIT_KERNEL}
    want_sites["attention"] = spatial_sites["attention"]
    micro = TENSOR_STEPS * TENSOR_ACCUM
    for r in ranks:
        rec, t = r["composed"], r["timing"]
        wide = {route: dict(d) for route, d in rec["wide"].items()}
        split = {e: wide["split"].pop(e) for e in SPLIT_KERNEL}
        tr = rec["traffic"]
        peers = pair[r["rank"] % DIST_RANKS]
        print(f"rank {r['rank']} tensor=2 x spatial=2 fit of {LSUN_CONFIG}: {rec['wall_s']:.2f} s "
              f"wall, launches {rec['launches']}, split K1/K2 {split} (one process K1/K2 "
              f"{one['launches']}), other wide launches {wide}; holds {rec['state_bytes']:,} B of "
              f"parameters, EMA and moments ({rec['tensor_split']} kernels split); peak allocated "
              f"through the microbatches' forwards and backwards "
              f"{rec['peak_bytes'] / 2**30:.3f} GiB (a spatial rank "
              f"{peers['spatial']['peak_bytes'] / 2**30:.3f}, a tensor rank "
              f"{peers['tensor']['peak_bytes'] / 2**30:.3f}, one process "
              f"{one['peak_bytes'] / 2**30:.3f} GiB); a microbatch's halo exchanges "
              f"{tr['halos'] / micro:g}, statistics all-reduces {tr['all_reduces'] / micro:g} and "
              f"row gathers {tr['gathers'] / micro:g} over the spatial group, channel all-gathers "
              f"{tr['channel_gathers'] / micro:g} and reduce-scatters "
              f"{tr['channel_scatters'] / micro:g} over the tensor group; the largest halo "
              f"exchange ({t['halo_shape']} edge rows, {t['halo_kb']:.1f} KB gathered) "
              f"{t['halo_ms']:.3f} ms, the largest channel all-gather ({t['gather_shape']} a "
              f"rank, {t['gather_kb']:.1f} KB gathered) {t['gather_ms']:.3f} ms, transport "
              f"{t['transport']}; split entries against their plain versions "
              f"{rec['split_max_abs']}, K3 {rec['k3_max_abs']:.3e} [{card}]", flush=True)
        sites = {k: rec["sites"][k] for k in want_sites}
        if rec["launches"] != want or split != want_split or any(
                v for d in wide.values() for v in d.values()):
            fail(f"rank {r['rank']}'s composed fit launched {rec['launches']}, split {split}, "
                 f"wide {wide}; expected {want} and split {want_split}")
        if sites != want_sites:
            fail(f"rank {r['rank']}'s composed fit called the kernels at {sites}, expected the "
                 f"spatial rank's sites at C/2: {want_sites}")
        if rec["state_bytes"] != TENSOR_BYTES or rec["tensor_split"] != TENSOR_SPLIT:
            fail(f"a composed rank holds {rec['state_bytes']} B in {rec['tensor_split']} split "
                 f"kernels, expected {TENSOR_BYTES} in {TENSOR_SPLIT}")
    lead = ranks[0]["composed"]
    mesh_rows = _jsonl(os.path.join(DIST_ROOT, "composed", "metrics.jsonl"))
    one_rows = _jsonl(os.path.join(DIST_ROOT, "tensor_one", "metrics.jsonl"))
    rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(mesh_rows, one_rows)]
           for k in ("loss", "grad_norm")}
    lit = tcfg.instantiate(tcfg.validate_config(tcfg.load_config(LSUN_CONFIG))["model"])
    state = CheckpointManager(os.path.join(DIST_ROOT, "composed")).restore(
        lit.init_state(0, device="cuda"))
    restored = state_digest(torch, state)
    del state, lit
    torch.cuda.empty_cache()
    spatial_groups = [[r["composed"]["digest"] for r in ranks[i:i + 2]] for i in (0, 2)]
    out["composed"] = {
        "loss_rel": rel["loss"], "grad_norm_rel": rel["grad_norm"],
        "grad_rel_l2": lead["grad_rel"], "params": lead["params"],
        "spatial_groups_bitwise": all(a == b for a, b in spatial_groups),
        "tensor_shards_differ": spatial_groups[0][0] != spatial_groups[1][0],
        "gathered_alike": all(r["composed"]["whole_digest"] == lead["whole_digest"]
                              for r in ranks),
        "checkpoint_bitwise": restored == lead["whole_digest"],
        "step_s": [2 * TENSOR_ACCUM / row["imgs_per_sec"] for row in mesh_rows],
        "peak_bytes": [r["composed"]["peak_bytes"] for r in ranks],
        "spatial_peak_bytes": [r["spatial"]["peak_bytes"] for r in pair],
        "tensor_peak_bytes": [r["tensor"]["peak_bytes"] for r in pair],
        "one_peak_bytes": one["peak_bytes"],
        "fit_peak_bytes": [r["composed"]["fit_peak_bytes"] for r in ranks],
        "wall_s": [r["composed"]["wall_s"] for r in ranks],
        "per_microbatch": {k: lead["traffic"][k] / micro for k in (
            "halos", "all_reduces", "gathers", "channel_gathers", "channel_scatters")},
        "halo_ms": [r["timing"]["halo_ms"] for r in ranks],
        "gather_ms": [r["timing"]["gather_ms"] for r in ranks]}
    c = out["composed"]
    print(f"tensor=2 x spatial=2 against one process: loss relative {rel['loss']}, grad norm "
          f"relative {rel['grad_norm']} (limit {TENSOR_LOSS_REL}), the first reduced gradient "
          f"{lead['grad_rel']:.3e} relative L2 (limit {GRAD_REL_L2}); a step of {TENSOR_ACCUM} "
          f"microbatches on rank 0 {c['step_s']} s (host clock); the ranks of each spatial group "
          f"{'are' if c['spatial_groups_bitwise'] else 'are NOT'} bitwise equal, every rank's "
          f"gathered state {'is' if c['gathered_alike'] else 'is NOT'} alike, the checkpoint "
          f"restored without a mesh {'is' if c['checkpoint_bitwise'] else 'is NOT'} bit for bit "
          f"it ({lead['params']:,} parameters) [{card}]", flush=True)
    if (len(mesh_rows) != TENSOR_STEPS or len(one_rows) != TENSOR_STEPS
            or max(rel["loss"] + rel["grad_norm"]) > TENSOR_LOSS_REL):
        fail(f"the composed run's losses and grad norms are {rel} from the one process's")
    if not lead["grad_rel"] <= GRAD_REL_L2:
        fail(f"the composed run's first gradient is {lead['grad_rel']} from the one process's")
    if not (c["spatial_groups_bitwise"] and c["tensor_shards_differ"] and c["gathered_alike"]
            and c["checkpoint_bitwise"] and lead["params"] == LSUN_PARAMS):
        fail("the composed ranks' states differ within a spatial group or gathered, or the "
             "checkpoint restored without a mesh is not theirs")

    # the expert x spatial fit of DIST_CONFIG
    per_rank = launches_for(PER_TRAIN_STEP, DIST_STEPS)
    want = dict(per_rank, group_norm_silu=0, group_norm_silu_bwd=0)
    want_split = {e: per_rank[k] for e, k in SPLIT_KERNEL.items()}
    for r in ranks:
        rec = r["expert_spatial"]
        wide = {route: dict(d) for route, d in rec["wide"].items()}
        split = {e: wide["split"].pop(e) for e in SPLIT_KERNEL}
        print(f"rank {r['rank']} expert=2 x spatial=2 fit of {DIST_CONFIG}: {rec['wall_s']:.2f} s "
              f"wall, launches {rec['launches']}, split K1/K2 {split}, other wide launches "
              f"{wide} [{card}]", flush=True)
        if rec["launches"] != want or split != want_split or any(
                v for d in wide.values() for v in d.values()):
            fail(f"rank {r['rank']}'s expert x spatial fit launched {rec['launches']}, split "
                 f"{split}, wide {wide}; expected {want} and split {want_split}")
    saved = {k: CheckpointManager(os.path.join(DIST_ROOT, k)).load(DIST_STEPS)
             for k in ("one", "expert_spatial")}
    parts = ("params", "ema_params", "mu", "nu")
    got = {part: (s[part] if part in s else s["opt_state"][part]) for s in (
        saved["expert_spatial"],) for part in parts}
    diff = {part: _rel_l2(torch, saved["one"][part] if part in saved["one"]
                          else saved["one"]["opt_state"][part], got[part]) for part in parts}
    mesh_rows = _jsonl(os.path.join(DIST_ROOT, "expert_spatial", "metrics.jsonl"))
    one_rows = _jsonl(os.path.join(DIST_ROOT, "one", "metrics.jsonl"))
    rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(mesh_rows, one_rows)]
           for k in ("loss", "grad_norm")}
    lead = ranks[0]["expert_spatial"]["digest"]
    saved_digest = {"params": digest(torch, got["params"]), "ema": digest(torch, got["ema_params"]),
                    "mu": digest(torch, got["mu"]), "nu": digest(torch, got["nu"])}
    out["expert_spatial"] = {
        "vs_one": diff, "loss_rel": rel["loss"], "grad_norm_rel": rel["grad_norm"],
        "ranks_bitwise": all(r["expert_spatial"]["digest"] == lead for r in ranks),
        "checkpoint_bitwise": saved_digest == lead,
        "step_ms": statistics.median(1e3 * TRAIN_BATCH / row["imgs_per_sec"]
                                     for row in mesh_rows[1:]),
        "wall_s": [r["expert_spatial"]["wall_s"] for r in ranks]}
    e = out["expert_spatial"]
    print(f"expert=2 x spatial=2 against one process at batch {DIST_BATCH} accumulating "
          f"{DIST_RANKS}: relative L2 " + ", ".join(f"{k} {v:.3e}" for k, v in diff.items())
          + f" (parameters and EMA limit {EXPERT_SPATIAL_REL}); loss relative {rel['loss']}, "
          f"grad norm relative {rel['grad_norm']} (limit {EXPERT_LOSS_REL}); a rank's step "
          f"{e['step_ms']:.2f} ms (host clock, median after the first); every rank's state "
          f"{'is' if e['ranks_bitwise'] else 'is NOT'} bitwise equal, the checkpoint "
          f"{'is' if e['checkpoint_bitwise'] else 'is NOT'} bit for bit theirs [{card}]",
          flush=True)
    if max(diff["params"], diff["ema_params"]) > EXPERT_SPATIAL_REL:
        fail(f"the expert x spatial state is {diff} from the one process's")
    if len(mesh_rows) != DIST_STEPS or max(rel["loss"] + rel["grad_norm"]) > EXPERT_LOSS_REL:
        fail(f"the expert x spatial run's losses and grad norms are {rel} from the one process's")
    if not (e["ranks_bitwise"] and e["checkpoint_bitwise"]):
        fail("the expert x spatial ranks' states differ, or the checkpoint is not theirs")
    return out


def spatial_phase(torch, out: dict, ranks: list, card: str) -> None:
    """Phase 49's checks of the spatial fit (:func:`spatial_fit`) against the
    tensor fit's one process ``out["tensor_one"]`` (the same batches and
    draws), into ``out["spatial"]``: each rank's split K1/K2 launches the one
    process's K1/K2 launches, its K3 launches the one process's, no launch
    of the one-call K1/K2, of f32, fp16 or ``simt.cu``; its split entries and
    K3 held on its own inputs; the losses and grad norms within
    ``TENSOR_LOSS_REL``, the first reduced gradient within ``GRAD_REL_L2``
    (relative L2); both ranks' states bitwise equal, and the checkpoint
    restored without a mesh bitwise theirs; each rank's peak below the one
    process's."""
    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.training import CheckpointManager

    one = out["tensor_one"]
    want = dict(one["launches"], group_norm_silu=0, group_norm_silu_bwd=0)
    want_split = {"sums": one["launches"]["group_norm_silu"],
                  "apply": one["launches"]["group_norm_silu"],
                  "bwd_sums": one["launches"]["group_norm_silu_bwd"],
                  "bwd_dx": one["launches"]["group_norm_silu_bwd"]}
    micro = TENSOR_STEPS * TENSOR_ACCUM
    for r in ranks:
        rec, t = r["spatial"], r["timing"]["spatial"]
        wide = {route: dict(d) for route, d in rec["wide"].items()}
        split = {e: wide["split"].pop(e) for e in SPLIT_KERNEL}
        tr = rec["traffic"]
        print(f"rank {r['rank']} spatial=2 fit of {LSUN_CONFIG}: {rec['wall_s']:.2f} s wall, "
              f"launches {rec['launches']}, split K1/K2 {split} (one process K1/K2 "
              f"{one['launches']}), other wide launches {wide}; peak allocated through the "
              f"microbatches' forwards and backwards {rec['peak_bytes'] / 2**30:.3f} GiB (one "
              f"process {one['peak_bytes'] / 2**30:.3f} GiB), through the whole fit "
              f"{rec['fit_peak_bytes'] / 2**30:.3f} GiB (one process "
              f"{one['fit_peak_bytes'] / 2**30:.3f} GiB); a microbatch's "
              f"halo exchanges "
              f"{tr['halos'] / micro:g}, statistics all-reduces {tr['all_reduces'] / micro:g}, "
              f"row gathers {tr['gathers'] / micro:g}; the largest halo exchange "
              f"({t['halo_shape']} edge rows, {t['halo_kb']:.1f} KB gathered) "
              f"{t['halo_ms']:.3f} ms, transport {t['transport']}; split entries against their "
              f"plain versions {rec['split_max_abs']}, K3 {rec['k3_max_abs']:.3e} [{card}]",
              flush=True)
        if rec["launches"] != want or split != want_split or any(
                v for d in wide.values() for v in d.values()):
            fail(f"rank {r['rank']}'s spatial fit launched {rec['launches']}, split {split}, "
                 f"wide {wide}; expected {want} and split {want_split}")
        if not rec["peak_bytes"] < one["peak_bytes"]:
            fail(f"a spatial rank's peak {rec['peak_bytes']} is not below the one process's "
                 f"{one['peak_bytes']}")
    lead = ranks[0]["spatial"]
    mesh_rows = _jsonl(os.path.join(DIST_ROOT, "spatial", "metrics.jsonl"))
    one_rows = _jsonl(os.path.join(DIST_ROOT, "tensor_one", "metrics.jsonl"))
    rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(mesh_rows, one_rows)]
           for k in ("loss", "grad_norm")}
    lit = tcfg.instantiate(tcfg.validate_config(tcfg.load_config(LSUN_CONFIG))["model"])
    state = CheckpointManager(os.path.join(DIST_ROOT, "spatial")).restore(
        lit.init_state(0, device="cuda"))
    restored = state_digest(torch, state)
    del state, lit
    torch.cuda.empty_cache()
    out["spatial"] = {
        "loss_rel": rel["loss"], "grad_norm_rel": rel["grad_norm"],
        "grad_rel_l2": lead["grad_rel"], "params": lead["params"],
        "ranks_bitwise": all(r["spatial"]["digest"] == lead["digest"] for r in ranks),
        "checkpoint_bitwise": restored == lead["digest"],
        "step_s": [2 * TENSOR_ACCUM / row["imgs_per_sec"] for row in mesh_rows],
        "peak_bytes": [r["spatial"]["peak_bytes"] for r in ranks],
        "one_peak_bytes": one["peak_bytes"],
        "fit_peak_bytes": [r["spatial"]["fit_peak_bytes"] for r in ranks],
        "one_fit_peak_bytes": one["fit_peak_bytes"],
        "wall_s": [r["spatial"]["wall_s"] for r in ranks],
        "per_microbatch": {k: lead["traffic"][k] / micro
                           for k in ("halos", "all_reduces", "gathers")},
        "halo_ms": [r["timing"]["spatial"]["halo_ms"] for r in ranks]}
    print(f"spatial=2 against one process: loss relative {rel['loss']}, grad norm relative "
          f"{rel['grad_norm']} (limit {TENSOR_LOSS_REL}), the first reduced gradient "
          f"{lead['grad_rel']:.3e} relative L2 (limit {GRAD_REL_L2}); a step of {TENSOR_ACCUM} "
          f"microbatches on rank 0 {out['spatial']['step_s']} s (host clock); the two ranks' "
          f"states {'are' if out['spatial']['ranks_bitwise'] else 'are NOT'} bitwise equal; the "
          f"checkpoint restored without a mesh "
          f"{'is' if out['spatial']['checkpoint_bitwise'] else 'is NOT'} bit for bit theirs "
          f"[{card}]", flush=True)
    if (len(mesh_rows) != TENSOR_STEPS or len(one_rows) != TENSOR_STEPS
            or max(rel["loss"] + rel["grad_norm"]) > TENSOR_LOSS_REL):
        fail(f"the spatial=2 run's losses and grad norms are {rel} from the one process's")
    if not lead["grad_rel"] <= GRAD_REL_L2:
        fail(f"the spatial=2 run's first gradient is {lead['grad_rel']} from the one process's")
    if not (out["spatial"]["ranks_bitwise"] and out["spatial"]["checkpoint_bitwise"]
            and lead["params"] == LSUN_PARAMS):
        fail("the spatial=2 ranks' states differ, or the checkpoint restored without a mesh "
             "is not theirs")


def split_fit_rows(report: dict, ranks: list, fit: str, groups: int) -> list:
    """The kernels line's rows of an H-split fit ``fit`` of ``LSUN_CONFIG``
    (its ranks' records ``ranks``; GroupNorms of ``groups`` groups on a
    rank): each split entry per rank microbatch (phase 3's time at each
    shard shape and group count, the fit's call sites on rank 0 a
    microbatch), launches in all the ranks' fit; K3 per microbatch (phase
    47's, whole on every rank), launches likewise."""
    micro = TENSOR_STEPS * TENSOR_ACCUM
    timed = {}  # by shard shape and groups: each was timed once, with its pre-bias where it has one
    for row in report["split"]["rows"]:
        if "sums" in row:
            n, h, w, c = row["shape"]
            timed[(n, h // DIST_RANKS, w, c, row["groups"])] = row
    lead = ranks[0][fit]
    rows = []
    for entry, kname in SPLIT_KERNEL.items():
        v = {f: 0.0 for f in ("ms", "plain_ms", "bound_ms")}
        worst, by = 0.0, {}
        for key, count in lead["sites"][entry].items():
            row = timed[(*ast.literal_eval(key)[0], groups)]
            for f in v:
                v[f] += row[entry][f] * count / micro
            by[row[entry]["bound_by"]] = by.get(row[entry]["bound_by"], 0.0) + (
                row[entry]["bound_ms"] * count)
            worst = max(worst, row["max_abs_err"])
        v.update(library_ms=None, bound_by=max(by, key=by.get),
                 max_abs_err=max(worst, *(r[fit]["split_max_abs"][entry] for r in ranks)))
        cname = entry if entry.startswith("bwd") else f"fwd_{entry}"  # group_norm.cu's name
        r = _table_row(f"group_norm_silu_{cname}_{fit}_train", kname, v,
                       sum(r[fit]["wide"]["split"][entry] for r in ranks))
        rows.append(r)
    k3 = _table_row(f"attention_{fit}_train", "attention",
                    report["lsun_fit"]["per_microbatch"]["attention"],
                    sum(r[fit]["launches"]["attention"] for r in ranks))
    k3["max_abs_err"] = max(k3["max_abs_err"], *(r[fit]["k3_max_abs"] for r in ranks))
    return rows + [k3]


def dit_tensor_references(torch, ops, card: str) -> dict:
    """The DiT tensor fits' references: each config of ``DIT_TENSOR`` fitted
    here in one process, no mesh, on the batches and draws of the tensor
    group, every zero-initialised weight drawn; its first gradients saved
    under ``DIST_ROOT`` for the ranks. {"<key>_tensor_one": the run}."""
    out = {}
    for key, config in DIT_TENSOR.items():
        first = {}
        with drawn_init(torch), first_gradients(torch, first):
            out[f"{key}_tensor_one"] = cli_run(
                torch, ops, card, f"one process: fit {config} {DIT_TENSOR_STEPS} steps at batch "
                f"{TRAIN_BATCH}, no mesh",
                _dist_fit_argv(os.path.join(DIST_ROOT, f"{key}_tensor_one"), "--trainer.mesh",
                               "null", config=config, steps=DIT_TENSOR_STEPS),
                launches_for(PER_FORWARD_DIT, DIT_TENSOR_STEPS))
        torch.save(first["grads"], os.path.join(DIST_ROOT, f"{key}_tensor_one_grads.pt"))
        del first
        torch.cuda.empty_cache()
    return out


def dit_tensor_fits(torch, k_attn, ops, cli, held: dict, out: str, dev, rank: int) -> dict:
    """In a rank: ``trainer.main fit`` (``cli``) of each config of
    ``DIT_TENSOR`` on ``TENSOR_MESH``, every zero-initialised weight drawn:
    {"<key>_tensor": its wall time, launches, the bytes it leaves the rank
    holding (``held``, filled by the rank's ``fit``), its K3 call sites and
    K3 against its plain version on their inputs; on rank 0 also the
    gathered state's digest and its first reduced gradient against the one
    process's (``<out>/<key>_tensor_one_grads.pt``)}."""
    recs = {}
    for key, config in DIT_TENSOR.items():
        tag, first = f"{key}_tensor", {}
        with drawn_init(torch), first_gradients(torch, first):
            reset_counts(ops)
            torch.cuda.synchronize()
            t0 = time.time()
            argv = _dist_fit_argv(os.path.join(out, tag), "--trainer.mesh", TENSOR_MESH,
                                  config=config, steps=DIT_TENSOR_STEPS)
            calls = record_calls(dit_targets(k_attn, False), lambda argv=argv: cli(argv))
            torch.cuda.synchronize()
            state = held.pop("state")
            recs[tag] = dict(held, wall_s=time.time() - t0, launches=counts(ops),
                             wide=wide_counts(), split_leaves=len(state.tensor_axes),
                             sites={repr(s): n for s, n, _, _ in calls["attention"]},
                             k3_max_abs=k3_held(torch, k_attn, calls))
        del calls
        whole = state.whole()  # a collective: both ranks
        if rank == 0:
            recs[tag]["digest"] = state_digest(torch, whole)
            recs[tag]["params"] = sum(v.numel() for v in whole.params.values())
            want = torch.load(os.path.join(out, f"{tag}_one_grads.pt"), map_location=dev)
            recs[tag]["grad_rel"] = _rel_l2(torch, want, first["grads"])
        del state, whole, first
        torch.cuda.empty_cache()
    return recs


def _rel_l2(torch, a: dict, b: dict) -> float:
    x = torch.cat([v.reshape(-1).double() for v in a.values()])
    y = torch.cat([b[k].reshape(-1).double() for k in a])
    return float((x - y).norm() / x.norm())


def dist_phase(torch, np, blocks, k_gn, k_attn, init_weights, ops, dev, card: str,
               eval_rec: dict, lsun_rec: dict, dit_rec: dict) -> dict:
    """Phases 49 and 50: configs/ddpm/cifar10.yaml (the 32,416,643-parameter
    UNet, bf16, K1/K2/K3) on two ranks that share the card, each launched by
    ``torch.distributed.run`` (:func:`rank_worker`; deterministic cuDNN),
    at global batch 128 on synthetic data for ``DIST_STEPS`` steps: a data=2
    fit whose saved state is bitwise that of one process at batch 64 with
    ``accumulate_grad_batches 2`` (run here), an fsdp=2 fit within 1e-6
    (relative L2) of it whose ranks each hold about half the data ranks'
    bytes of parameters, EMA and moments; each rank's launches a batch-64
    step's, none of f32, fp16 or ``simt.cu``; each rank's step and the
    gradient all-reduce timed. Then ``trainer.main test`` of
    configs/ddim/cifar10.yaml from phase 46's run on a data=2 mesh, one test
    batch a rank: phase 46's FID and IS, each rank one batch's launches.
    K1/K2/K3 at every call site of a batch-64 step held against their plain
    versions here; the test's K1/K3/K4 shapes are phase 46's. In the same
    launch the expert fit (:func:`expert_phase`) and the tensor fit of
    ``LSUN_CONFIG`` against one process here on its batches
    (:func:`tensor_phase`, :func:`tensor_kernels`; ``lsun_rec``: phase 47's
    record, whose microbatch K3 sites the tensor ranks share), and the
    tensor fits of ``DIT_CONFIG`` and ``MOE_CONFIG`` against one process
    here on their batches (:func:`dit_tensor_phase`; ``dit_rec``: phase
    35's record, whose batch-128 training step's K3 sites a DiT tensor rank
    shares), and the spatial fit of ``LSUN_CONFIG`` against the tensor
    fit's one process (:func:`spatial_phase`)."""
    import shutil

    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.training import CheckpointManager

    shutil.rmtree(DIST_ROOT, ignore_errors=True)
    os.makedirs(DIST_ROOT)
    torch.backends.cudnn.deterministic = True
    accumulate = ["--trainer.mesh", "null", "--data.init_args.batch_size", str(DIST_BATCH),
                  "--trainer.accumulate_grad_batches", str(DIST_RANKS)]
    out = {"one": cli_run(torch, ops, card, f"one process: fit {DIST_STEPS} steps at batch "
                          f"{DIST_BATCH} x {DIST_RANKS} accumulated",
                          _dist_fit_argv(os.path.join(DIST_ROOT, "one"), *accumulate),
                          launches_for(PER_TRAIN_STEP, DIST_STEPS * DIST_RANKS))}
    first = {}
    with drawn_init(torch), first_gradients(torch, first):
        out["moe_one"] = cli_run(torch, ops, card, f"one process: fit {MOE_CONFIG} {DIST_STEPS} "
                                 f"steps at batch {DIST_BATCH} x {DIST_RANKS} accumulated",
                                 _dist_fit_argv(os.path.join(DIST_ROOT, "moe_one"), *accumulate,
                                                config=MOE_CONFIG),
                                 launches_for(PER_FORWARD_DIT, DIST_STEPS * DIST_RANKS))
    torch.save(first["grads"], os.path.join(DIST_ROOT, "moe_one_grads.pt"))
    del first
    torch.cuda.empty_cache()
    # the tensor fit's reference: the LSUN UNet in one process, no mesh, on
    # the same batches and draws (the tensor ranks share one batch slice)
    write_lsun_lmdb(np, os.path.join(DIST_ROOT, "lsun", "church_outdoor_train_lmdb"),
                    TENSOR_IMAGES)
    config = tcfg.validate_config(tcfg.apply_overrides(tcfg.load_config(LSUN_CONFIG),
                                                       LSUN_KERNELS))
    out["tensor_sites"] = config_sites(torch, blocks, config["model"]["init_args"]["model"])[0]
    first, peaks = {}, {}
    with drawn_init(torch), first_gradients(torch, first), step_peaks(torch, peaks):
        out["tensor_one"] = cli_run(
            torch, ops, card, f"one process: fit {LSUN_CONFIG} {TENSOR_STEPS} steps of "
            f"{TENSOR_ACCUM} microbatches, no mesh",
            _tensor_fit_argv(os.path.join(DIST_ROOT, "tensor_one"), "--trainer.mesh", "null"),
            launches_for(out["tensor_sites"], TENSOR_STEPS * TENSOR_ACCUM))
    out["tensor_one"].update(peak_bytes=peaks["fwd_bwd"], fit_peak_bytes=peaks["fit"])
    torch.save(first["grads"], os.path.join(DIST_ROOT, "tensor_one_grads.pt"))
    del first
    torch.cuda.empty_cache()
    out.update(dit_tensor_references(torch, ops, card))
    eval_root = eval_rec["kept_root"]
    pth = os.path.join(EVAL_ROOT, "pt_inception_standin.pth")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(DIST_RANKS), os.path.abspath(__file__), "--rank-worker", DIST_ROOT,
           "--eval-root", eval_root, "--inception", pth]
    out["launch_wall_s"] = launch_ranks(cmd, os.path.join(DIST_ROOT, "torchrun.log"),
                                        DIST_TIMEOUT, "two-rank")
    ranks = []
    for r in range(DIST_RANKS):
        with open(os.path.join(DIST_ROOT, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    out["ranks"] = ranks
    if {r["backend"] for r in ranks} != {"gloo"}:
        fail(f"two ranks on one card joined over {[r['backend'] for r in ranks]}, not gloo")

    # phase 49: the fits
    per_rank = launches_for(PER_TRAIN_STEP, DIST_STEPS)
    for r in ranks:
        for kind in ("data", "fsdp"):
            rec = r[kind]
            print(f"rank {r['rank']} {kind}=2 fit: {rec['wall_s']:.2f} s wall, launches "
                  f"{rec['launches']}, f32/fp16 launches {rec['wide']}, holds "
                  f"{rec['state_bytes'] / 2**20:.1f} MiB of parameters, EMA and moments "
                  f"({rec['split_leaves']} leaves split) [{card}]", flush=True)
            if rec["launches"] != per_rank:
                fail(f"rank {r['rank']}'s {kind} fit launched {rec['launches']}, "
                     f"expected {per_rank}")
            if any(v for d in rec["wide"].values() for v in d.values()):
                fail(f"rank {r['rank']}'s {kind} fit launched the f32/fp16 kernels")
        share = r["fsdp"]["state_bytes"] / r["data"]["state_bytes"]
        print(f"rank {r['rank']}: fsdp state {share:.4f} of the data rank's", flush=True)
        if not 0.45 <= share <= 0.55:
            fail(f"an fsdp rank holds {share:.3f} of a data rank's state, not about half")
        t = r["timing"]
        print(f"rank {r['rank']}: the gradient all-reduce of {t['allreduce_mb']:.1f} MB through "
              f"gloo {t['allreduce_ms']:.2f} ms (host clock, median of {DIST_TIMED}) [{card}]",
              flush=True)
    out["step_ms"] = {kind: fit_step_ms(kind) for kind in ("data", "fsdp", "expert")}
    print(f"a step at batch {DIST_BATCH} a rank (global {TRAIN_BATCH}): "
          f"{out['step_ms']['data']:.2f} ms on data=2, {out['step_ms']['fsdp']:.2f} ms on "
          f"fsdp=2, {out['step_ms']['expert']:.2f} ms on {EXPERT_MESH} (host clock, the median "
          f"of the fits' logged steps after the first) [{card}]", flush=True)
    expert_phase(torch, np, out, ranks, card)
    tensor_phase(torch, out, ranks, card)
    spatial_phase(torch, out, ranks, card)
    dit_tensor_phase(torch, out, ranks, card, dit_rec, dev)
    saved = {k: CheckpointManager(os.path.join(DIST_ROOT, k)).load(DIST_STEPS)
             for k in ("one", "data", "fsdp")}
    out["data_vs_one"] = state_differences(torch, saved["data"], saved["one"])
    out["fsdp_vs_data"] = {part: _rel_l2(torch, *(
        s[part] if part in s else s["opt_state"][part] for s in (saved["data"], saved["fsdp"])))
        for part in ("params", "ema_params", "mu", "nu")}
    print(f"data=2 against one process accumulating 2: {len(out['data_vs_one'])} tensors differ; "
          f"fsdp=2 against data=2, relative L2: " + ", ".join(
              f"{k} {v:.3e}" for k, v in out["fsdp_vs_data"].items()), flush=True)
    if out["data_vs_one"]:
        fail(f"the data=2 state differs from one process's in {out['data_vs_one'][:5]}")
    if out["fsdp_vs_data"]["params"] > DIST_FSDP_REL:
        fail(f"the fsdp=2 parameters are {out['fsdp_vs_data']['params']:.3e} from data=2's")

    # phase 50: the two-rank test against phase 46's one process
    want = eval_rec["repeat"]["results"]
    printed = [ln for ln in ranks[0]["test"]["printed"].splitlines() if ln.startswith("{'fid'")]
    if len(printed) != 1 or ranks[1]["test"]["printed"].count("{'fid'"):
        fail("the two-rank test did not print its results on rank 0 alone")
    import ast

    got = ast.literal_eval(printed[0])
    out["test"] = {"results": got, "want": want,
                   "fid_rel": abs(got["fid"] - want["fid"]) / abs(want["fid"]),
                   "is_rel": abs(got["inception_score"] - want["inception_score"])
                   / abs(want["inception_score"])}
    print(f"two-rank test: {got}; one process (phase 46): {want}; FID relative difference "
          f"{out['test']['fid_rel']:.3e}, IS {out['test']['is_rel']:.3e} [{card}]", flush=True)
    if (got["num_batches"] != EVAL_BATCHES or out["test"]["fid_rel"] > FID_REL
            or out["test"]["is_rel"] > STATS_REL_L2):
        fail(f"the two-rank test gave {got}, phase 46 {want}")
    one_batch = launches_for(eval_rec["sites"]["ddim"], 50)
    for r in ranks:
        rec = r["test"]
        print(f"rank {r['rank']} test: {rec['wall_s']:.2f} s wall, launches {rec['launches']} "
              f"[{card}]", flush=True)
        if rec["launches"] != one_batch or any(v for d in rec["wide"].values()
                                               for v in d.values()):
            fail(f"rank {r['rank']}'s test launched {rec['launches']} ({rec['wide']}), "
                 f"expected one batch's {one_batch}")
    shutil.rmtree(eval_root, ignore_errors=True)

    # K1/K2/K3 at every call site of a rank's step (batch 64)
    config = tcfg.validate_config(tcfg.load_config(DIST_CONFIG))
    step = train_kernels(torch, blocks, k_gn, k_attn, None, init_weights, None, dev, card, ops,
                         lit=tcfg.instantiate(config["model"]), batch_size=DIST_BATCH)
    out.update(train_rows=step["shapes"], per_step=step["per_step"])
    # K3 at every call site of a rank's expert step (batch 64; attention
    # sits outside the MoE layers, so a rank's shapes are a plain step's)
    out["expert_step"] = train_kernels(
        torch, blocks, k_gn, k_attn, None, init_weights, None, dev, card, ops,
        lit=dit_harness(torch, blocks, MOE_CONFIG)[0], targets=dit_targets(k_attn, True),
        sites={"attention": DIT_SITES, "attention_bwd": DIT_SITES}, batch_size=DIST_BATCH)
    out["tensor_step"] = tensor_kernels(torch, blocks, k_gn, k_attn, init_weights, dev, card,
                                        out, lsun_rec)
    return out  # DIST_ROOT stays for the four-rank launch (quad_phase)


def tensor_phase(torch, out: dict, ranks: list, card: str) -> None:
    """Phase 49's checks of the tensor fit (:func:`rank_worker`) against
    the one process ``out["tensor_one"]``, into ``out["tensor"]``: each
    rank's launches those of the one process, none of f32, fp16 or
    ``simt.cu``; its bytes ``TENSOR_BYTES`` in ``TENSOR_SPLIT`` split
    kernels; the losses and grad norms within ``TENSOR_LOSS_REL``, the
    first reduced gradient within ``GRAD_REL_L2`` (relative L2); the
    checkpoint restored without a mesh bitwise the gathered state."""
    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.training import CheckpointManager

    want = out["tensor_one"]["launches"]
    for r in ranks:
        rec, t = r["tensor"], r["timing"]["tensor"]
        print(f"rank {r['rank']} tensor=2 fit of {LSUN_CONFIG}: {rec['wall_s']:.2f} s wall, "
              f"launches {rec['launches']} (one process {want}), f32/fp16/simt launches "
              f"{rec['wide']}, holds {rec['state_bytes']:,} B of parameters, EMA and moments "
              f"({rec['state_bytes'] / (16 * LSUN_PARAMS):.4f} of the whole's "
              f"{16 * LSUN_PARAMS:,}; {rec['split_leaves']} kernels split); the all-gather of "
              f"the largest activation ({t['gather_mb']:.2f} MB whole) {t['gather_ms']:.2f} ms, "
              f"transport {t['transport']} [{card}]", flush=True)
        if rec["launches"] != want or any(v for d in rec["wide"].values() for v in d.values()):
            fail(f"rank {r['rank']}'s tensor fit launched {rec['launches']} ({rec['wide']}), "
                 f"expected the one process's {want}")
        if rec["state_bytes"] != TENSOR_BYTES or rec["split_leaves"] != TENSOR_SPLIT:
            fail(f"a tensor rank holds {rec['state_bytes']} B in {rec['split_leaves']} split "
                 f"kernels, expected {TENSOR_BYTES} in {TENSOR_SPLIT}")
    lead = ranks[0]["tensor"]
    mesh_rows = _jsonl(os.path.join(DIST_ROOT, "tensor", "metrics.jsonl"))
    one_rows = _jsonl(os.path.join(DIST_ROOT, "tensor_one", "metrics.jsonl"))
    rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(mesh_rows, one_rows)]
           for k in ("loss", "grad_norm")}
    step_s = {name: [2 * TENSOR_ACCUM / row["imgs_per_sec"] for row in rows]
              for name, rows in (("mesh", mesh_rows), ("one", one_rows))}
    lit = tcfg.instantiate(tcfg.validate_config(tcfg.load_config(LSUN_CONFIG))["model"])
    state = CheckpointManager(os.path.join(DIST_ROOT, "tensor")).restore(
        lit.init_state(0, device="cuda"))
    restored = state_digest(torch, state)
    n_params = sum(v.numel() for v in state.params.values())
    del state, lit
    torch.cuda.empty_cache()
    out["tensor"] = {"loss_rel": rel["loss"], "grad_norm_rel": rel["grad_norm"],
                     "grad_rel_l2": lead["grad_rel"], "params": lead["params"],
                     "checkpoint_bitwise": restored == lead["digest"], "step_s": step_s,
                     "gather_ms": [r["timing"]["tensor"]["gather_ms"] for r in ranks]}
    print(f"tensor=2 against one process: loss relative {rel['loss']}, grad norm relative "
          f"{rel['grad_norm']} (limit {TENSOR_LOSS_REL}), the first reduced gradient "
          f"{lead['grad_rel']:.3e} relative L2 (limit {GRAD_REL_L2}); a step of "
          f"{TENSOR_ACCUM} microbatches on rank 0 {step_s['mesh']} s, in the one process "
          f"{step_s['one']} s (host clock); the checkpoint restored without a mesh "
          f"{'is' if out['tensor']['checkpoint_bitwise'] else 'is NOT'} bit for bit the ranks' "
          f"gathered state ({lead['params']:,} parameters gathered, {n_params:,} restored) "
          f"[{card}]", flush=True)
    if (len(mesh_rows) != TENSOR_STEPS or len(one_rows) != TENSOR_STEPS
            or max(rel["loss"] + rel["grad_norm"]) > TENSOR_LOSS_REL):
        fail(f"the tensor=2 run's losses and grad norms are {rel} from the one process's")
    if not lead["grad_rel"] <= GRAD_REL_L2:
        fail(f"the tensor=2 run's first gradient is {lead['grad_rel']} from the one process's")
    if not out["tensor"]["checkpoint_bitwise"] or {lead["params"], n_params} != {LSUN_PARAMS}:
        fail("the tensor=2 checkpoint restored without a mesh is not the gathered state")


def dit_tensor_phase(torch, out: dict, ranks: list, card: str, dit_rec: dict, dev) -> None:
    """Phase 49's checks of the DiT and MoE-DiT tensor fits
    (:func:`rank_worker`) against the one processes ``out["<key>_tensor_one"]``,
    into ``out["<key>_tensor"]``: each rank's launches those of the one
    process, none of f32, fp16 or ``simt.cu``, its K3 call sites those of
    phase 35's batch-128 step (the attention runs whole on every rank) and
    K3 within ``TOL`` of its plain version on the rank's own inputs; its
    bytes ``DIT_TENSOR_BYTES`` in ``DIT_TENSOR_SPLIT`` split kernels; the
    losses and grad norms within ``TENSOR_LOSS_REL``, the first reduced
    gradient within ``GRAD_REL_L2`` (relative L2); the checkpoint restored
    without a mesh bitwise the gathered state."""
    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.training import CheckpointManager

    for key, config in DIT_TENSOR.items():
        tag, n_params = f"{key}_tensor", DIT_PARAMS if key == "dit" else MOE_PARAMS
        want = out[f"{tag}_one"]["launches"]
        sites = {r["key"]: DIT_TENSOR_STEPS * r["sites"] for r in dit_rec[f"{key}_train"]["shapes"]
                 if r["kernel"] == "attention"}
        for r in ranks:
            rec, t = r[tag], r["timing"]["tensor"][key]
            print(f"rank {r['rank']} tensor=2 fit of {config}: {rec['wall_s']:.2f} s wall, "
                  f"launches {rec['launches']} (one process {want}), f32/fp16/simt launches "
                  f"{rec['wide']}, K3 sites {rec['sites']} (phase 35's step x "
                  f"{DIT_TENSOR_STEPS}: {sites}), K3 max_abs {rec['k3_max_abs']:.3e} from its "
                  f"plain version on the rank's inputs; holds {rec['state_bytes']:,} B of "
                  f"parameters, EMA and moments ({rec['state_bytes'] / (16 * n_params):.4f} of "
                  f"the whole's {16 * n_params:,}; {rec['split_leaves']} kernels split); the "
                  f"all-gather of the largest activation ({t['gather_mb']:.2f} MB whole) "
                  f"{t['gather_ms']:.2f} ms [{card}]", flush=True)
            if rec["launches"] != want or any(v for d in rec["wide"].values() for v in d.values()):
                fail(f"rank {r['rank']}'s {key} tensor fit launched {rec['launches']} "
                     f"({rec['wide']}), expected the one process's {want}")
            if rec["sites"] != sites:
                fail(f"rank {r['rank']}'s {key} tensor fit called K3 at {rec['sites']}, "
                     f"expected {sites}")
            if (rec["state_bytes"] != DIT_TENSOR_BYTES[key]
                    or rec["split_leaves"] != DIT_TENSOR_SPLIT):
                fail(f"a {key} tensor rank holds {rec['state_bytes']} B in "
                     f"{rec['split_leaves']} split kernels, expected {DIT_TENSOR_BYTES[key]} in "
                     f"{DIT_TENSOR_SPLIT}")
        lead = ranks[0][tag]
        mesh_rows = _jsonl(os.path.join(DIST_ROOT, tag, "metrics.jsonl"))
        one_rows = _jsonl(os.path.join(DIST_ROOT, f"{tag}_one", "metrics.jsonl"))
        rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(mesh_rows, one_rows)]
               for k in ("loss", "grad_norm")}
        step_s = {name: [TRAIN_BATCH / row["imgs_per_sec"] for row in rows]
                  for name, rows in (("mesh", mesh_rows), ("one", one_rows))}
        cfg = tcfg.apply_overrides(tcfg.load_config(config), DIST_DATA)
        lit = tcfg.instantiate(tcfg.validate_config(cfg)["model"])
        state = CheckpointManager(os.path.join(DIST_ROOT, tag)).restore(
            lit.init_state(0, device=dev))
        restored = state_digest(torch, state)
        restored_params = sum(v.numel() for v in state.params.values())
        del state, lit
        torch.cuda.empty_cache()
        out[tag] = {"loss_rel": rel["loss"], "grad_norm_rel": rel["grad_norm"],
                    "grad_rel_l2": lead["grad_rel"], "params": lead["params"],
                    "checkpoint_bitwise": restored == lead["digest"], "step_s": step_s,
                    "gather_ms": [r["timing"]["tensor"][key]["gather_ms"] for r in ranks],
                    "k3_max_abs": max(r[tag]["k3_max_abs"] for r in ranks)}
        print(f"{key} tensor=2 against one process: loss relative {rel['loss']}, grad norm "
              f"relative {rel['grad_norm']} (limit {TENSOR_LOSS_REL}), the first reduced "
              f"gradient {lead['grad_rel']:.3e} relative L2 (limit {GRAD_REL_L2}); a step on "
              f"rank 0 {step_s['mesh']} s, in the one process {step_s['one']} s (host clock); "
              f"the checkpoint restored without a mesh "
              f"{'is' if out[tag]['checkpoint_bitwise'] else 'is NOT'} bit for bit the ranks' "
              f"gathered state ({lead['params']:,} parameters gathered, {restored_params:,} "
              f"restored) [{card}]", flush=True)
        if (len(mesh_rows) != DIT_TENSOR_STEPS or len(one_rows) != DIT_TENSOR_STEPS
                or max(rel["loss"] + rel["grad_norm"]) > TENSOR_LOSS_REL):
            fail(f"the {key} tensor=2 run's losses and grad norms are {rel} from the one "
                 "process's")
        if not lead["grad_rel"] <= GRAD_REL_L2:
            fail(f"the {key} tensor=2 run's first gradient is {lead['grad_rel']} from the one "
                 "process's")
        if not out[tag]["checkpoint_bitwise"] or {lead["params"], restored_params} != {n_params}:
            fail(f"the {key} tensor=2 checkpoint restored without a mesh is not the gathered "
                 "state")


def tensor_kernels(torch, blocks, k_gn, k_attn, init_weights, dev, card: str, out: dict,
                   lsun_rec: dict) -> dict:
    """K1 and K2 at every call site of a tensor rank's microbatch, held
    against their plain versions and timed: the LSUN UNet at half its
    channels and groups has a rank's shard shapes (C/2 channels in G/2
    groups at every GroupNorm, the FiLM-free pre-bias (N, C/2)). Fails
    unless each rank's K1/K2 call sites in the tensor fit are these, and
    its K3 sites phase 47's microbatch's (the attention runs whole)."""
    from dmme_tpu_torch import config as tcfg

    config = tcfg.validate_config(tcfg.apply_overrides(tcfg.load_config(LSUN_CONFIG),
                                                       LSUN_KERNELS))
    node = config["model"]["init_args"]["model"]
    args = node["init_args"]
    half = dict(node, init_args=dict(args, channels_per_depth=[
        c // DIST_RANKS for c in args["channels_per_depth"]],
        num_groups=args.get("num_groups", 32) // DIST_RANKS))
    lit = tcfg.instantiate(dict(config["model"], init_args=dict(config["model"]["init_args"],
                                                                model=half)))
    gn = (blocks, "group_norm_silu", "group_norm_silu", _sig_gn)
    gn_bwd = (k_gn, "group_norm_silu_bwd", "group_norm_silu_bwd", _sig_gn_bwd)
    sites = {k: out["tensor_sites"][k] for k in ("group_norm_silu", "group_norm_silu_bwd")}
    step = train_kernels(torch, blocks, k_gn, k_attn, None, init_weights, None, dev, card,
                         lit=lit, batch_size=2, sites=sites, img_size=LSUN_IMG,
                         targets=[gn, gn_bwd])
    micro = TENSOR_STEPS * TENSOR_ACCUM
    want = {k: {r["key"]: micro * r["sites"] for r in step["shapes"] if r["kernel"] == k}
            for k in sites}
    want.update({k: {r["key"]: micro * r["sites"] for r in lsun_rec["rows"] if r["kernel"] == k}
                 for k in ("attention", "attention_bwd")})
    for r in out["ranks"]:
        if r["tensor"]["sites"] != want:
            fail(f"rank {r['rank']}'s tensor fit called the kernels at {r['tensor']['sites']}, "
                 f"expected {want}")
    print(f"each rank's K1/K2 call sites in the tensor fit are the half-width UNet's, its K3 "
          f"sites phase 47's: {want} [{card}]", flush=True)
    return step


def expert_phase(torch, np, out: dict, ranks: list, card: str) -> None:
    """Phase 49's checks of the expert fit (:func:`rank_worker`) against
    the accumulating process ``out["moe_one"]``, into ``out["expert"]``."""
    from dmme_tpu_torch import config as tcfg
    from dmme_tpu_torch.training import CheckpointManager

    per_rank = launches_for(PER_FORWARD_DIT, DIST_STEPS)
    for r in ranks:
        rec, t = r["expert"], r["timing"]["expert"]
        print(f"rank {r['rank']} expert=2 fit of {MOE_CONFIG}: {rec['wall_s']:.2f} s wall, "
              f"launches {rec['launches']}, f32/fp16 launches {rec['wide']}, holds "
              f"{rec['state_bytes']:,} B of parameters, EMA and moments "
              f"({rec['state_bytes'] / (16 * MOE_PARAMS):.4f} of the whole's "
              f"{16 * MOE_PARAMS:,}; {rec['split_leaves']} stacks split); "
              f"the all-to-all of one block's {t['a2a_mb']:.2f} MB dispatch buffer "
              f"{t['a2a_ms']:.3f} ms, transport {t['transport']} [{card}]", flush=True)
        if rec["launches"] != per_rank or any(v for d in rec["wide"].values()
                                              for v in d.values()):
            fail(f"rank {r['rank']}'s expert fit launched {rec['launches']} ({rec['wide']}), "
                 f"expected {per_rank}")
        if rec["state_bytes"] != EXPERT_BYTES or rec["split_leaves"] != EXPERT_STACKS:
            fail(f"an expert rank holds {rec['state_bytes']} B in {rec['split_leaves']} split "
                 f"stacks, expected {EXPERT_BYTES} in {EXPERT_STACKS}")
    lead = ranks[0]["expert"]
    mesh_rows = _jsonl(os.path.join(DIST_ROOT, "expert", "metrics.jsonl"))
    one_rows = _jsonl(os.path.join(DIST_ROOT, "moe_one", "metrics.jsonl"))
    rel = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(mesh_rows, one_rows)]
           for k in ("loss", "grad_norm")}
    # the mesh run's checkpoint, restored here without a mesh
    lit = tcfg.instantiate(tcfg.validate_config(tcfg.load_config(MOE_CONFIG))["model"])
    state = CheckpointManager(os.path.join(DIST_ROOT, "expert")).restore(
        lit.init_state(0, device="cuda"))
    restored = state_digest(torch, state)
    n_params = sum(v.numel() for v in state.params.values())
    del state, lit
    torch.cuda.empty_cache()
    out["expert"] = {"loss_rel": rel["loss"], "grad_norm_rel": rel["grad_norm"],
                     "grad_rel_l2": lead["grad_rel"], "params": lead["params"],
                     "checkpoint_bitwise": restored == lead["digest"],
                     "transport": ranks[0]["timing"]["expert"]["transport"]}
    print(f"expert=2 against one process accumulating {DIST_RANKS}: loss relative "
          f"{rel['loss']}, grad norm relative {rel['grad_norm']}, the first reduced gradient "
          f"{lead['grad_rel']:.3e} relative L2 (limit {GRAD_REL_L2}); the checkpoint restored "
          f"without a mesh {'is' if out['expert']['checkpoint_bitwise'] else 'is NOT'} bit for "
          f"bit the ranks' gathered state ({lead['params']:,} parameters gathered, {n_params:,} "
          f"restored) [{card}]", flush=True)
    if (len(mesh_rows) != DIST_STEPS or len(one_rows) != DIST_STEPS
            or max(rel["loss"] + rel["grad_norm"]) > EXPERT_LOSS_REL):
        fail(f"the expert=2 run's losses and grad norms are {rel} from the accumulating run's")
    if not lead["grad_rel"] <= GRAD_REL_L2:
        fail(f"the expert=2 run's first gradient is {lead['grad_rel']} from the accumulating's")
    if not out["expert"]["checkpoint_bitwise"] or {lead["params"], n_params} != {MOE_PARAMS}:
        fail("the expert=2 checkpoint restored without a mesh is not the gathered state")


def dist_rows(report: dict) -> list:
    """The kernels line's rows of the two-rank paths: K1/K2/K3 per rank step
    at batch 64 (launches in both ranks' data=2 and fsdp=2 fits), K1/K3/K4
    per DDIM-50 forward of a test batch at N = 128 (phase 46's shapes;
    launches in both ranks' test)."""
    d = report["dist"]
    rows = [_table_row(f"{k}_mesh_train", k, d["per_step"][k],
                       sum(r[kind]["launches"][k] for r in d["ranks"] for kind in ("data", "fsdp")))
            for k in ("group_norm_silu", "group_norm_silu_bwd", "attention")]
    rows += [_table_row(f"{k}_mesh_test", k, report["eval_test"]["per_forward"][k],
                        sum(r["test"]["launches"][k] for r in d["ranks"]))
             for k in ("group_norm_silu", "attention", "resblock")]
    rows.append(_table_row("attention_expert_train", "attention",
                           d["expert_step"]["per_step"]["attention"],
                           sum(r["expert"]["launches"]["attention"] for r in d["ranks"])))
    per_rank = dict(d["tensor_step"]["per_step"],
                    attention=report["lsun_fit"]["per_microbatch"]["attention"])
    rows += [_table_row(f"{k}_tensor_train", k, per_rank[k],
                        sum(r["tensor"]["launches"][k] for r in d["ranks"]))
             for k in ("group_norm_silu", "group_norm_silu_bwd", "attention")]
    for key in DIT_TENSOR:
        v = report["dit_kernels"][f"{key}_train"]["per_step"]["attention"]
        row = _table_row(f"attention_{key}_tensor_train", "attention", v,
                         sum(r[f"{key}_tensor"]["launches"]["attention"] for r in d["ranks"]))
        row["max_abs_err"] = max(v["max_abs_err"], d[f"{key}_tensor"]["k3_max_abs"])
        rows.append(row)
    return rows


def record_forwards(torch, blocks, runs, dev, targets=None) -> tuple:
    """Record the K1/K3/K4 inputs of eval forwards (``targets``: the entry
    points, by default :func:`serve_targets`). ``runs``: {name: (model, x,
    t, expected call sites[, forward keyword arguments])}; fails if a
    forward's call sites differ.
    Returns ({kind: {signature: {"a", "k", "sites": {name: count}}}},
    {name: call sites})."""
    targets = serve_targets(blocks) if targets is None else targets
    recorded = {kind: {} for _, _, kind, _ in targets}
    site_counts = {}
    for name, (m, xs, ts, want, *kw) in runs.items():
        kw = kw[0] if kw else {}
        with torch.no_grad():
            calls = record_calls(targets,
                                 lambda m=m, xs=xs, ts=ts, kw=kw: m(xs.to(dev), ts.to(dev), **kw))
        site_counts[name] = {k: sum(c for _, c, _, _ in v) for k, v in calls.items()}
        if site_counts[name] != {k: want[k] for k in site_counts[name]}:
            fail(f"UNet forward ({name}) has call sites {site_counts[name]}, expected {want}")
        for kind_, lst in calls.items():
            for key, count, a, k in lst:
                entry = recorded[kind_].setdefault(key, {"a": a, "k": k, "sites": {}})
                entry["sites"][name] = count
    return recorded, site_counts


def forward_rows(torch, k_gn, k_attn, k_res, build, dev, recorded) -> tuple:
    """Hold every recorded K1/K3/K4 call of a UNet forward against its plain
    version (``TOL``) and time it: median of ``KERNEL_REPS`` CUDA-event runs (the plain
    version's of ``PLAIN_REPS``), the bound,
    SDPA beside K3, the library sequences beside K1 and K4. ``recorded``:
    {kind: {signature: {"a", "k", "sites"}}}. Returns (rows, failures)."""
    plain = {
        "group_norm_silu": lambda x, g, b, groups, eps=k_gn.GN_EPS, pre_bias=None:
            k_gn.gn_silu_plain(x, g, b, pre_bias, groups, eps)[0],
        "attention": k_attn.attention_heads_plain,
        "resblock": k_res.resblock_plain,
    }
    kernel = {"group_norm_silu": k_gn.group_norm_silu, "attention": k_attn.attention_heads,
              "resblock": k_res.resblock_forward}
    shapes = []
    failures = []
    with torch.no_grad():
        for kind_, entries in recorded.items():
            rtol, atol = TOL[kind_]
            for key, e in entries.items():
                a, k = e["a"], e["k"]
                if kind_ == "resblock":
                    pa = list(a) + [k.get("wr"), k.get("br"), k.get("num_groups", 32),
                                    k.get("eps", k_gn.GN_EPS)]
                    plain_fn = lambda pa=pa: plain["resblock"](*pa)  # noqa: E731
                else:
                    plain_fn = lambda a=a, k=k, kind_=kind_: plain[kind_](*a, **k)  # noqa: E731
                kern_fn = lambda a=a, k=k, kind_=kind_: kernel[kind_](*a, **k)  # noqa: E731
                got = kern_fn()
                torch.cuda.synchronize()
                want = plain_fn()
                max_abs, max_rel, ok = errors(got, want, rtol, atol)
                same = bool(torch.equal(got, kern_fn()))  # a second call: the same bytes
                rec = {
                    "kernel": kind_, "key": repr(key), "sites": e["sites"],
                    "max_abs_err": max_abs, "max_rel_err": max_rel,
                    "rtol": rtol, "atol": atol, "ok": ok and same, "repeat_identical": same,
                    "ms": device_ms(torch, kern_fn),
                    "plain_ms": device_ms(torch, plain_fn, reps=PLAIN_REPS, warm=PLAIN_WARM),
                }
                rec["bound_ms"], rec["bound_by"] = bound_ms(kind_, a, k)
                rec["library_ms"] = None
                if kind_ == "attention":
                    q, kk, v, scale = a
                    sdpa = lambda q=q, kk=kk, v=v, scale=scale: (  # noqa: E731
                        torch.nn.functional.scaled_dot_product_attention(
                            q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2),
                            scale=scale))
                    rec["library_ms"] = device_ms(torch, sdpa)
                    rec["plan"] = attention_plan(k_attn, q, kk, v)
                elif kind_ == "group_norm_silu":
                    rec["plan"] = gn_plan(k_gn, a[0], a[3], False)
                    rec["torch_seq_ms"] = device_ms(torch, gn_sequence(torch, a, k))
                elif kind_ == "resblock":
                    try:
                        rec["cudnn_seq_ms"] = device_ms(torch, cudnn_sequence(torch, pa))
                    except RuntimeError as err:  # a yardstick only: note it and go on
                        rec["cudnn_seq_ms"] = None
                        print(f"cudnn sequence at {key}: {err}", flush=True)
                    x_ = a[0]
                    cin_, cout_ = x_.shape[3], a[6].shape[0]
                    p1 = k_res.conv_plan(*x_.shape[:3], cin_, cout_, 0, build.sm_count(dev))
                    p2 = k_res.conv_plan(*x_.shape[:3], cout_, cout_,
                                         cin_ if k.get("wr") is not None else 0,
                                         build.sm_count(dev))
                    rec["plan"] = {"conv1": p1._asdict(), "conv2": p2._asdict()}
                shapes.append(rec)
                print(f"{kind_:16s} {str(key):58s} sites {e['sites']} "
                      f"max_abs {max_abs:.3e} max_rel {max_rel:.3e} (rtol {rtol}, atol {atol}) "
                      f"ms {rec['ms']:.4f} plain {rec['plain_ms']:.4f} bound {rec['bound_ms']:.4f} "
                      f"({rec['bound_by']})"
                      + (f" sdpa {rec['library_ms']:.4f}" if rec["library_ms"] else "")
                      + (f" cudnn_seq {rec['cudnn_seq_ms']:.4f}" if rec.get("cudnn_seq_ms") else "")
                      + (f" torch_seq {rec['torch_seq_ms']:.4f} plan {rec['plan']}"
                         if kind_ == "group_norm_silu" else "")
                      + ("" if same else " repeat DIFFERENT")
                      + ("" if rec["ok"] else "  FAIL"), flush=True)
                if not rec["ok"]:
                    failures.append(f"{kind_} {key}")
    return shapes, failures


_REPLACES = {"group_norm_silu": ("group_norm.cu", "dmme_tpu/ops/group_norm.py:72"),
             "group_norm_silu_bwd": ("group_norm.cu", "dmme_tpu/ops/group_norm.py:110"),
             "attention": ("attention.cu", "dmme_tpu/ops/attention.py:47"),
             "resblock": ("resblock.cu", "dmme_tpu/ops/resblock.py:88")}


def _table_row(name: str, kname: str, v: dict, launches: int) -> dict:
    """A row of the kernels line from per-site sums (:func:`per_site_sum`)."""
    src, replaces = _REPLACES[kname]
    return {"name": name, "route": "cuda", "source": f"dmme_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": launches, "max_abs_err": v["max_abs_err"],
            "ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": v["library_ms"]}


def write_report(path: str, report: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)


def slice_rows(report: dict, shapes) -> list:
    """The kernels line's rows of the DiT, distillation and inpainting paths.
    DiT and MoE-DiT: K3 per forward at n = 8 (launches in the default flow
    request) and per step at batch 128 (launches in the 10-step CLI fits);
    distillation: K1/K2/K3/K4 per step at batch 128, the teacher's two
    forwards and the student's step (launches in the driver's rounds);
    inpainting: K1/K3/K4 per n = 8 forward at the DDPM serving shapes of
    phase 3 (launches in the inpainting run)."""
    rows = []
    dk, dc, ds = report["dit_kernels"], report["dit_cli"], report["dit_serve"]
    for key in ("dit", "moe"):
        rows.append(_table_row(f"attention_{key}", "attention",
                               dk["per_forward"][key]["attention"],
                               ds[key]["launches"]["attention"]))
        fit = dc["whole" if key == "dit" else "moe_fit"]
        rows.append(_table_row(f"attention_{key}_train", "attention",
                               dk[f"{key}_train"]["per_step"]["attention"],
                               fit["launches"]["attention"]))
    distill_launches = report["distill"]["driver"]["launches"]
    for kname, v in report["distill_kernels"]["per_step"].items():
        if kname != "attention_bwd":
            rows.append(_table_row(f"{kname}_distill", kname, v, distill_launches[kname]))
    serve_flat = [dict(r, sites=r["sites"]["both"]) for r in shapes if "both" in r["sites"]]
    for kname in ("group_norm_silu", "attention", "resblock"):
        rows.append(_table_row(f"{kname}_inpaint", kname, per_site_sum(serve_flat, kname),
                               report["inpaint"]["launches"][kname]))
    return rows


def per_forward_summary(shapes, card: str) -> dict:
    """K3's and K4's times summed over the call sites of one batch-8 UNet
    forward (both switches on), beside their yardsticks."""
    out = {}
    for kname, extra in (("attention", ("library_ms",)), ("resblock", ("cudnn_seq_ms",))):
        recs = [r for r in shapes if r["kernel"] == kname and "both" in r["sites"]]
        row = {}
        for f in ("ms", "bound_ms") + extra:
            vals = [r.get(f) for r in recs]
            row[f] = (None if any(v is None for v in vals)
                      else sum(v * r["sites"]["both"] for v, r in zip(vals, recs)))
        out[kname] = row
        print(f"per batch-8 UNet forward, {kname}: "
              + ", ".join(f"{f} {v:.4f}" for f, v in row.items() if v is not None)
              + f" [{card}]", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write all measurements here (JSON)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phases (build, serving and training shapes)")
    ap.add_argument("--rank-worker", metavar="DIR", default=None,
                    help="(internal) one rank of the two-rank phases, under torch.distributed.run")
    ap.add_argument("--quad-worker", metavar="DIR", default=None,
                    help="(internal) one rank of the four-rank phase, under torch.distributed.run")
    ap.add_argument("--eval-root", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--inception", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_worker:
        return rank_worker(args.rank_worker, args.eval_root, args.inception)
    if args.quad_worker:
        return quad_worker(args.quad_worker)

    import torch

    phase("device")
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the port on a GPU", file=sys.stderr)
        return 1
    card = nvidia_smi()
    device_name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {device_name}", flush=True)

    import numpy as np

    import dmme_tpu_torch.models.blocks as blocks
    from dmme_tpu_torch.models import ddpm as ddpm_models
    from dmme_tpu_torch.models import init_weights
    from dmme_tpu_torch.ops import attention as k_attn
    from dmme_tpu_torch.ops import build
    from dmme_tpu_torch.ops import group_norm as k_gn
    from dmme_tpu_torch.ops import resblock as k_res
    from dmme_tpu_torch.serving import SAMPLERS, Sampler, make_server
    from dmme_tpu_torch.training import LitDDIM, TrainState

    ops = kernel_counters(k_gn, k_attn, k_res)
    report = {"card": card, "torch": torch.__version__, "device": device_name}

    phase("build")
    t0 = time.time()
    build.build_all(verbose=True)
    report["build_s"] = time.time() - t0
    print(f"built {', '.join(build.SOURCES)} in {report['build_s']:.1f} s", flush=True)
    report["ptxas"] = ptxas_report(build)
    for src, kernels in report["ptxas"].items():
        for name, u in kernels.items():
            print(f"  {src}.cu {name}: {u['registers']} registers, spill stores "
                  f"{u['spill_stores']} B, spill loads {u['spill_loads']} B", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}; cudnn deterministic", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    x_in = torch.randn((BATCH, 32, 32, 3), generator=gen)
    t_in = torch.randint(1, 1000, (BATCH,), generator=gen)
    settings = {"both": dict(fused_norm=True, fused_block=True),
                "fused_norm": dict(fused_norm=True, fused_block=False)}
    # kernel launches (and call sites) of one UNet forward
    expect = {"both": {"group_norm_silu": 1, "group_norm_silu_bwd": 0, "attention": 6,
                       "resblock": 22},
              "fused_norm": {"group_norm_silu": 45, "group_norm_silu_bwd": 0, "attention": 6,
                             "resblock": 0}}
    models = {}
    for name, sw in settings.items():
        m = ddpm_models.UNet(dtype=torch.bfloat16, **sw)
        init_weights(m, torch.Generator().manual_seed(SEED))
        randomize_affines(torch, blocks, m, torch.Generator().manual_seed(SEED + 1))
        models[name] = m.to(dev).eval()

    phase("kernels against their plain versions")
    # the serving path's forwards: batch 8 under both switch settings, and
    # the other request sizes the serve phase sends, 1 and 16, whose shapes
    # take other plans (a key split, 4x4 tiles that reach past the batch)
    runs = {name: (models[name], x_in, t_in, expect[name]) for name in models}
    for n in SERVE_BATCHES:
        if n != BATCH:
            g = torch.Generator().manual_seed(SEED + n)
            runs[f"both_n{n}"] = (models["both"], torch.randn((n, 32, 32, 3), generator=g),
                                  torch.randint(1, 1000, (n,), generator=g), expect["both"])
    recorded, site_counts = record_forwards(torch, blocks, runs, dev)
    print(f"call sites per UNet forward: {json.dumps(site_counts)}", flush=True)

    shapes, failures = forward_rows(torch, k_gn, k_attn, k_res, build, dev, recorded)
    report["shapes"] = shapes
    if failures:
        fail(f"kernels disagree with their plain versions: {failures}")
    del recorded
    report["per_forward"] = per_forward_summary(shapes, card)
    # the spatial axis's split K1/K2 entries at the LSUN levels, halves added here
    report["split"] = split_kernels(torch, blocks, k_gn, dev, card)
    if args.kernels_only:
        phase("train kernels: one full-width bf16 training step at batch 128")
        from dmme_tpu_torch.training import LitDDPM

        del models
        torch.cuda.empty_cache()
        report["train_kernels"] = train_kernels(torch, blocks, k_gn, k_attn, ddpm_models,
                                                init_weights, LitDDPM, dev, card)
        phase("off-path kernels: shapes outside the main path against their plain versions")
        report["offpath"] = offpath_kernels(torch, k_gn, k_attn, k_res, dev)
        phase("simt.cu widths: K1 and K2 outside group_norm.cu's domain, in three dtypes")
        report["simt"] = simt_kernels(torch, k_gn, dev, ops)
        phase("LSUN widths: one UNet forward at batch 1, bf16 on the card vs f32 on the CPU")
        torch.set_num_threads(max(1, os.cpu_count() or 1))
        report["lsun"] = lsun_forward(torch, blocks, ddpm_models, init_weights, k_gn, k_attn,
                                      k_res, ops, dev)
        torch.cuda.empty_cache()
        phase("f32 and fp16 K1 and K2: LitDDPM() and LitDDPM(dtype='fp16') training steps")
        report["f32"] = f32_phase(torch, np, blocks, init_weights, k_gn, k_attn, k_res, dev,
                                  ops, card, gn_only=True)
        if args.out:
            write_report(args.out, report)
        print("--kernels-only: stopped after the kernel phases; no result line", flush=True)
        return 0

    phase("unet forward, full width, bf16 on the card vs f32 on the CPU")
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    unet = {}
    for name, m in models.items():
        ref_model = ddpm_models.UNet(dtype=torch.float32, **settings[name])
        ref_model.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()}, strict=True)
        with torch.no_grad():
            want = ref_model(x_in, t_in)
            reset_counts(ops)
            got = m(x_in.to(dev), t_in.to(dev))
            torch.cuda.synchronize()
            per_call = counts(ops)
            expect_bf16_only(f"UNet forward ({name})")
            ms = device_ms(torch, lambda m=m: m(x_in.to(dev), t_in.to(dev)), reps=10)
        got = got.float().cpu()
        rel = float((got - want).norm() / want.norm())
        max_abs = float((got - want).abs().max())
        ok = bool(got.isfinite().all()) and got.shape == want.shape and rel <= UNET_REL_L2
        unet[name] = {"rel_l2": rel, "max_abs_err": max_abs, "ms": ms, "launches": per_call,
                      "ok": ok}
        print(f"{name:10s} shape {tuple(got.shape)} rel_l2 {rel:.3e} (<= {UNET_REL_L2}) "
              f"max_abs {max_abs:.3e} forward {ms:.3f} ms launches {per_call}"
              + ("" if ok else "  FAIL"), flush=True)
        if not ok:
            fail(f"UNet forward ({name}) disagrees with the f32 CPU reference")
        if per_call != expect[name]:
            fail(f"UNet forward ({name}) launched {per_call}, expected {expect[name]}")
    report["unet"] = unet
    del models

    phase("LSUN widths: one UNet forward at batch 1, bf16 on the card vs f32 on the CPU")
    report["lsun"] = lsun_forward(torch, blocks, ddpm_models, init_weights, k_gn, k_attn, k_res,
                                  ops, dev)
    torch.cuda.empty_cache()

    phase("serve: LitDDIM DDIM-50 over HTTP")
    lit = LitDDIM(dtype="bf16", timesteps=1000, sample_steps=50, tau_schedule="quadratic")
    lit.init_state(SEED)
    randomize_affines(torch, blocks, lit.model, torch.Generator().manual_seed(SEED + 1))
    state = TrainState.create({k: v.detach().clone() for k, v in lit.model.state_dict().items()},
                              lit.make_optimizer())
    sampler = Sampler(lit, state, img_size=32, device="cuda")
    url, stop = _serve(torch, sampler)
    serve = {}
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        print(f"healthz {health}", flush=True)
        if health.get("status") != "ok" or health.get("samplers") != list(SAMPLERS):
            fail(f"healthz: {health}")
        serve["requests"], launches = default_requests(np, url, ops, "DDPM", card)
        serve["solvers"] = solver_requests(np, url, ops, "DDPM", card, [
            (name, steps, launches_for(PER_FORWARD, steps)) for name, steps in SOLVERS])
        # the feature-caching samplers at refresh interval 2 (cache depth 1):
        # key steps run the full forward, the others the partial one
        serve["caching"] = solver_requests(np, url, ops, "DDPM", card, [
            (name, steps, launches_for(PER_FORWARD, steps, partial, 2))
            for name, steps, partial in CACHING])
        serve["rejected"] = {name: rejected(url, "DDPM", name, needle) for name, needle in (
            ("edm", "EDM-trained"), ("flow", "flow-matching-trained"))}
    finally:
        stop()
    print(f"kernel launches during the four requests: {launches}", flush=True)
    per_request = {k: expect["both"][k] * lit.diffusion_model.sub_timesteps * 4
                   for k in launches}
    if launches != per_request:
        fail(f"serve launched {launches}, expected {per_request}")
    serve["launches"] = launches
    report["serve"] = serve

    phase("where the device time goes: one request under torch.profiler")
    report["profile"] = {}
    for n in (BATCH,):
        prof = profile_request(torch, sampler, n)
        report["profile"][n] = prof
        print(f"n={n}: wall {prof['wall_ms']:.2f} ms (profiled), device busy "
              f"{prof['busy_ms']:.2f} ms, idle share {prof['idle_share']:.3f}", flush=True)
        for name, ms, count in prof["top"]:
            print(f"    {ms:9.3f} ms {count:6d}x  {name}", flush=True)
    # each caching sampler beside the exact solver it approximates (ddim:
    # the default request at n = 8 above, LitDDIM's DDIM-50)
    report["profile_samplers"] = {}
    for name in ("ddim", "cached", "deep", "dpm", "deep_dpm"):
        prof = (report["profile"][BATCH] if name == "ddim"
                else profile_request(torch, sampler, BATCH, name))
        report["profile_samplers"][name] = prof
        print(f"{name} n={BATCH}: wall {prof['wall_ms']:.2f} ms (profiled), device busy "
              f"{prof['busy_ms']:.2f} ms in {prof['device_ops']} operations, idle share "
              f"{prof['idle_share']:.3f} [{card}]", flush=True)

    from dmme_tpu_torch.diffusion import DDPM
    from dmme_tpu_torch.training import LitDDPM

    del sampler, state
    torch.cuda.empty_cache()
    phase("train kernels: one full-width bf16 training step at batch 128")
    train = train_kernels(torch, blocks, k_gn, k_attn, ddpm_models, init_weights, LitDDPM, dev,
                          card)
    report["train_kernels"] = train
    torch.cuda.empty_cache()

    phase("off-path kernels: shapes outside the main path against their plain versions")
    report["offpath"] = offpath_kernels(torch, k_gn, k_attn, k_res, dev)
    torch.cuda.empty_cache()
    phase("simt.cu widths: K1 and K2 outside group_norm.cu's domain, in three dtypes")
    report["simt"] = simt_kernels(torch, k_gn, dev, ops)

    phase("train gradient: loss_given + backward at batch 8, bf16 on the card vs f32 on the CPU")
    report["train_gradient"] = train_gradient(torch, blocks, init_weights,
                                              unet_pair(torch, ddpm_models), DDPM.create(1000),
                                              ddpm_draws(torch, np), dev, ops, PER_TRAIN_STEP)
    torch.cuda.empty_cache()

    # a user's defaults for the timed training: cuDNN may pick any algorithm
    torch.backends.cudnn.deterministic = False
    print("cudnn deterministic off for fit (the library default)", flush=True)
    phase("fit: LitDDPM(dtype='bf16') on CIFAR10(synthetic=True, batch_size=128)")
    trained_lit, trained = run_fit(torch, np, blocks, dev, ops, report, card)
    fit_launches = report["fit"]["launches"]

    phase("sample after training: DDIM-50 through K4 from the trained raw weights")
    report["sample_after_training"] = sample_after_training(torch, k_res, trained_lit, trained,
                                                            dev, ops)
    del trained_lit, trained
    k_res._PACKED.clear()
    torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic = True
    print("cudnn deterministic on for the IDDPM checks", flush=True)
    phase("IDDPM kernels: full-width forwards at n = 1, 8, 16 and a training step at batch 128")
    from dmme_tpu_torch.training import LitIDDPM

    report["iddpm_kernels"] = iddpm_kernels(torch, blocks, k_gn, k_attn, k_res, build,
                                            init_weights, dev, ops, card)
    torch.cuda.empty_cache()
    phase("IDDPM gradient: hybrid loss_given + backward at batch 8 with t = 1, bf16 card vs "
          "f32 CPU")
    report["iddpm_gradient"] = iddpm_gradient(torch, np, blocks, init_weights, dev, ops)
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    phase("IDDPM fit: LitIDDPM(configs/iddpm/cifar10.yaml, dtype='bf16') on "
          "CIFAR10(synthetic=True, batch_size=128)")
    run_fit(torch, np, blocks, dev, ops, report, card,
            lit=LitIDDPM(dtype="bf16", **IDDPM_CIFAR), per_step=PER_TRAIN_STEP_IDDPM,
            key="iddpm_fit")
    iddpm_fit_launches = report["iddpm_fit"]["launches"]
    torch.cuda.empty_cache()
    phase("IDDPM serve: LitIDDPM(dtype='bf16', sample_steps=50) over HTTP, and the solvers")
    report["iddpm_serve"] = iddpm_serve(torch, np, blocks, dev, ops, card)
    torch.cuda.empty_cache()

    phase("cli: dmme_tpu_torch.trainer.main on the repo's configs, in this process")
    report["cli"] = cli_phase(torch, np, ops, dev, card)
    torch.cuda.empty_cache()

    phase("f32 and fp16: LitDDPM() and LitDDIM() on the card (fault C.5): K1/K2 on "
          "group_norm.cu, K3/K4 on the tensor cores")
    report["f32"] = f32_phase(torch, np, blocks, init_weights, k_gn, k_attn, k_res, dev, ops,
                              card)
    torch.cuda.empty_cache()
    phase("f32 IDDPM: LitIDDPM() on the card (K3/K4 as 3xTF32)")
    report["f32_iddpm"] = f32_iddpm_phase(torch, np, blocks, init_weights, k_gn, k_attn, k_res,
                                          dev, ops, card)

    torch.cuda.empty_cache()
    phase("new call sites: EDM's and flow's forwards, the caching samplers' partial forwards, "
          "and the EDM and flow training steps")
    report["new_sites"] = new_site_kernels(torch, np, blocks, k_gn, k_attn, k_res, build,
                                           ddpm_models, init_weights, dev, ops, card)
    phase("EDM gradient: loss_given + backward at batch 8, σ from 0.002 to 80, bf16 card vs "
          "f32 CPU")
    from dmme_tpu_torch.diffusion import EDM

    report["edm_gradient"] = train_gradient(torch, blocks, init_weights,
                                            unet_pair(torch, ddpm_models), EDM.create(),
                                            edm_draws(torch, np, BATCH, SEED + 80), dev, ops,
                                            PER_TRAIN_STEP, "EDM training step")
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    print("cudnn deterministic off for the EDM and flow fits", flush=True)
    phase("EDM fit: trainer.main fit --config configs/edm/cifar10.yaml (synthetic data)")
    report["edm_fit"] = continuous_fit(torch, np, ops, dev, card, "edm")
    phase("EDM serve: LitEDM(dtype='bf16') over HTTP, default (18-step Heun) and edm")
    report["edm_serve"] = continuous_serve(torch, np, blocks, dev, ops, card, "edm")
    torch.cuda.empty_cache()
    phase("flow fit: trainer.main fit --config configs/flow/shapes_demo.yaml")
    report["flow_fit"] = continuous_fit(torch, np, ops, dev, card, "flow")
    phase("flow serve: LitFlow(dtype='bf16') over HTTP, default (25 midpoint steps) and flow")
    report["flow_serve"] = continuous_serve(torch, np, blocks, dev, ops, card, "flow")
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = True
    phase("f32 EDM: LitEDM() on the card (K3/K4 as 3xTF32)")
    report["f32_edm"] = f32_edm_phase(torch, np, blocks, ddpm_models, init_weights, dev, ops,
                                      card)
    torch.cuda.empty_cache()

    phase("CFG kernels: guided forwards at N = 2, 16, 32 and a labelled training step")
    report["cfg_kernels"] = cfg_kernels(torch, np, blocks, k_gn, k_attn, k_res, build,
                                        ddpm_models, init_weights, dev, ops, card)
    phase(f"CFG fit: trainer.main on {CFG_CONFIG}, resume bitwise, validate, sample")
    report["cfg_fit"] = cfg_fit(torch, np, blocks, ops, dev, card)
    torch.backends.cudnn.deterministic = False
    phase("CFG serve: LitDDIM(dtype='bf16', num_classes=2, guidance_scale=2) over HTTP")
    report["cfg_serve"] = cfg_serve(torch, np, blocks, dev, ops, card)
    torch.cuda.empty_cache()
    phase("guided IDDPM: LitIDDPM(num_classes=10, sample_steps=50, dtype='bf16')")
    report["cfg_iddpm"] = cfg_iddpm(torch, np, blocks, dev, ops, card)
    torch.cuda.empty_cache()
    phase(f"upsampler kernels: the UNet of {SR_CONFIG} at n = {BATCH} and batch {SR_BATCH}")
    report["sr_kernels"] = sr_kernels(torch, np, blocks, k_gn, k_attn, k_res, build,
                                      init_weights, dev, ops, card)
    phase(f"upsampler fit: trainer.main fit --config {SR_CONFIG}, then generate(low_res=)")
    report["sr_fit"] = sr_fit(torch, np, blocks, ops, dev, card)
    torch.backends.cudnn.deterministic = True
    phase("f32 CFG: LitDDPM(num_classes=10) on the card against the CPU")
    report["f32_cfg"] = f32_cfg_phase(torch, np, blocks, ddpm_models, init_weights, dev, ops,
                                      card)
    torch.cuda.empty_cache()

    phase("ADM kernels: K3 at ADM-32's and the classifier-32's call sites (serving forwards, "
          "training steps, a guided step)")
    report["adm_kernels"] = adm_kernels(torch, np, blocks, k_gn, k_attn, k_res, build, dev, ops,
                                        card)
    phase("ADM against the CPU: the bf16 forward and gradient, the f32 harnesses, "
          "classifier_grad")
    report["adm_vs_cpu"] = adm_vs_cpu(torch, np, blocks, dev, ops, card)
    phase(f"ADM fit: trainer.main fit --config {ADM_GUIDED} and {ADM_CLASSIFIER}, a resume")
    report["adm_cli"] = adm_cli(torch, np, ops, dev, card)
    phase(f"guidance: ClassifierGuidedDDIM-{GUIDED_STEPS} at n = {BATCH} and "
          "ClassifierGuidedDDPM steps")
    report["adm_guidance"] = adm_guidance(torch, np, blocks, dev, ops, card)
    phase(f"ADM serve: LitIDDPM(ADM-32, sample_steps={ADM_SERVE_STEPS}, dtype='bf16') over HTTP")
    report["adm_serve"] = adm_serve(torch, np, blocks, dev, ops, card)
    torch.cuda.empty_cache()

    phase(f"DiT kernels: K3 at the 12 call sites of {DIT_CONFIG} and {MOE_CONFIG} (a serving "
          f"forward at n = {BATCH}, a training step at batch {TRAIN_BATCH})")
    report["dit_kernels"] = dit_kernels(torch, np, blocks, k_gn, k_attn, k_res, build, dev, ops,
                                        card)
    phase("DiT against the CPU: the bf16 forward, the f32 DiT and MoE-DiT harnesses")
    report["dit_vs_cpu"] = dit_vs_cpu(torch, np, blocks, dev, ops, card)
    phase(f"DiT fit: trainer.main fit --config {DIT_CONFIG} (a resume) and {MOE_CONFIG}")
    report["dit_cli"] = dit_cli(torch, np, ops, dev, card)
    phase("DiT serve: the DiT and MoE-DiT flow harnesses over HTTP (25 midpoint steps)")
    report["dit_serve"] = dit_serve(torch, np, blocks, dev, ops, card)
    torch.backends.cudnn.deterministic = False
    phase(f"distillation kernels: one step at batch {TRAIN_BATCH} (the teacher's K4 at "
          f"N = {TRAIN_BATCH}, the student's K1/K2/K3)")
    report["distill_kernels"] = distill_kernels(torch, np, blocks, k_gn, k_attn, k_res, build,
                                                dev, ops, card)
    phase(f"distillation driver: python -m dmme_tpu_torch.distill on configs/ddpm/cifar10.yaml, "
          f"{DISTILL_ROUNDS} rounds from a teacher checkpoint, then a student request")
    report["distill"] = distill_driver(torch, np, ops, dev, card)
    phase(f"inpainting: RePaint with LitDDPM's UNet, a DDPM of T = {INPAINT_T}, resample_steps "
          f"{INPAINT_RESAMPLE}, n = {BATCH}")
    report["inpaint"] = inpaint_phase(torch, np, blocks, dev, ops, card)
    torch.cuda.empty_cache()

    phase("latent kernels: the latent UNet's forwards at n = 1, 8, 16 (2x2 ResBlocks, T = 4 "
          f"attention) and steps at batch {TRAIN_BATCH}; the stage-2 config UNet and DiT")
    report["latent_kernels"] = latent_kernels(torch, np, blocks, k_gn, k_attn, k_res, build, dev,
                                              ops, card)
    torch.backends.cudnn.deterministic = True
    phase("latent against the CPU: the bf16 codec and LitLatentDDPM step, the f32 LitVAE() "
          "and LitLatentDDPM()")
    report["latent_vs_cpu"] = latent_vs_cpu(torch, np, blocks, dev, ops, card)
    torch.cuda.empty_cache()
    phase(f"latent cli: trainer.main fit of {LATENT_VAE_CONFIG}, then {LATENT_DDPM_CONFIG} "
          f"(a resume) and {LATENT_DIT_CONFIG} from its run; sample; timed steps")
    report["latent_cli"] = latent_cli(torch, np, ops, dev, card)
    torch.cuda.empty_cache()
    phase("latent serve: LitLatentDDPM (ddim, dpm, the ancestral loop), the latent DiT flow "
          "and a LitVAE over HTTP")
    report["latent_serve"] = latent_serve(torch, np, blocks, dev, ops, card)
    torch.cuda.empty_cache()

    phase(f"eval inception: the FID network at batch {TRAIN_BATCH} in f32 against its unfolded "
          "twin and the CPU, preprocess, FeatureStats against float64, the FID tool")
    report["eval_inception"] = eval_inception(torch, np, dev, card)
    phase(f"eval test: trainer.main test on {DDIM_CONFIG} (save_fid_stats, fid_stats, a repeat, "
          f"dpm), {CFG_CONFIG}, {LATENT_DDPM_CONFIG}; the refusals; one batch split")
    report["eval_test"] = eval_test(torch, np, blocks, k_gn, k_attn, k_res, build, ops, dev,
                                    card, report["latent_cli"]["kept_roots"])
    torch.cuda.empty_cache()

    torch.backends.cudnn.deterministic = False
    print("cudnn deterministic off for the LSUN and ImageNet-64 runs", flush=True)
    phase(f"LSUN fit: trainer.main fit --config {LSUN_CONFIG} (batch 2 x 8 microbatches, 256 px, "
          "remat, T = 100) on a synthetic LMDB, ProfileTrace; one microbatch's kernels, the "
          "gradient")
    report["lsun_fit"] = lsun_fit(torch, np, blocks, k_gn, k_attn, k_res, build, init_weights, ops,
                                  dev, card)
    torch.cuda.empty_cache()
    phase(f"ImageNet-64: trainer.main fit --config {IN64_CONFIG} as written (its mesh: a world "
          "of 1 over NCCL) and with --trainer.mesh null (batch 128, 64 px), sample DDIM-50 at "
          "n = 8; the step with and without the mesh; the kernels at its call sites, the gradient")
    report["in64_fit"] = in64_fit(torch, np, blocks, k_gn, k_attn, k_res, build, init_weights, ops,
                                  dev, card)
    torch.cuda.empty_cache()

    phase(f"two ranks on one card: torch.distributed.run --nproc_per_node {DIST_RANKS} trainer "
          f"fit of {DIST_CONFIG} on data=2 and fsdp=2 meshes and of {MOE_CONFIG} on "
          f"{EXPERT_MESH} (gloo) against one process accumulating 2, of {LSUN_CONFIG}, "
          f"{DIT_CONFIG} and {MOE_CONFIG} on {TENSOR_MESH} and of {LSUN_CONFIG} on "
          f"{SPATIAL_MESH} against one process; then trainer test of {DDIM_CONFIG} on a data=2 "
          f"mesh")
    report["dist"] = dist_phase(torch, np, blocks, k_gn, k_attn, init_weights, ops, dev, card,
                                report["eval_test"], report["lsun_fit"], report["dit_kernels"])
    torch.cuda.empty_cache()
    phase(f"four ranks on one card: torch.distributed.run --nproc_per_node {QUAD_RANKS} trainer "
          f"fit of {LSUN_CONFIG} on {COMPOSED_MESH} against the tensor fit's one process, and of "
          f"{DIST_CONFIG} on {EXPERT_SPATIAL_MESH} against one process accumulating 2")
    report["quad"] = quad_phase(torch, report["dist"], card)
    import shutil

    shutil.rmtree(DIST_ROOT, ignore_errors=True)

    phase("kernels")
    sources = {
        "group_norm_silu": ("cuda", "dmme_tpu_torch/ops/csrc/group_norm.cu",
                            "dmme_tpu/ops/group_norm.py:72"),
        "attention": ("cuda", "dmme_tpu_torch/ops/csrc/attention.cu",
                      "dmme_tpu/ops/attention.py:47"),
        "resblock": ("cuda", "dmme_tpu_torch/ops/csrc/resblock.cu",
                     "dmme_tpu/ops/resblock.py:88"),
    }
    table = []
    for kname, (route, src, replaces) in sources.items():
        recs = [r for r in shapes if r["kernel"] == kname and "both" in r["sites"]]
        if not recs:
            fail(f"{kname} has no call site on the serving path")

        def per_forward(field, recs=recs):
            vals = [r[field] * r["sites"]["both"] for r in recs]
            return None if any(v is None for v in vals) else sum(vals)

        table.append({
            "name": kname, "route": route, "source": src, "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in shapes if r["kernel"] == kname),
            "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
            "bound_ms": per_forward("bound_ms"),
            "bound_by": max(recs, key=lambda r: r["bound_ms"] * r["sites"]["both"])["bound_by"],
            "library_ms": per_forward("library_ms") if kname == "attention" else None,
        })
    k2 = train["per_step"]["group_norm_silu_bwd"]
    table.insert(1, {
        "name": "group_norm_silu_bwd", "route": "cuda",
        "source": "dmme_tpu_torch/ops/csrc/group_norm.cu",
        "replaces": "dmme_tpu/ops/group_norm.py:110",
        "launches": fit_launches["group_norm_silu_bwd"],
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"], "library_ms": None,
    })
    # the default harness's dtypes: K1–K4 in that dtype, launches in the
    # phase's training step and DDIM step
    for dname in ("f32", "fp16"):
        rec = report["f32"][dname]
        for kname in ("group_norm_silu", "group_norm_silu_bwd", "attention", "resblock"):
            row = _table_row(f"{kname}_{dname}", kname, rec["per_path"][kname],
                             rec["train"]["wide"][dname][kname]
                             + rec["ddim_step"]["wide"][dname][kname])
            row["max_abs_err"] = max(r["max_abs_err"] for r in rec["rows"] + rec["rows_ddim"]
                                     if r["kernel"] == kname)
            table.append(row)
    # the IDDPM path: K1, K3, K4 per n = 8 forward (launches in the four
    # default requests), K2 per training step (launches in the 20 fit steps)
    ik = report["iddpm_kernels"]
    for kname in ("group_norm_silu", "group_norm_silu_bwd", "attention", "resblock"):
        if kname == "group_norm_silu_bwd":
            v, n_launch = ik["train"]["per_step"][kname], iddpm_fit_launches[kname]
        else:
            v, n_launch = ik["per_forward"][kname], report["iddpm_serve"]["launches"][kname]
        table.append(_table_row(f"{kname}_iddpm", kname, v, n_launch))
    # this slice's call sites: K1/K3/K4 per n = 8 forward of EDM and flow
    # (launches in their default requests) and of the caching samplers'
    # non-key steps (launches in those steps of their n = 8 requests: the
    # request's less its key forwards'), K1/K2/K3 per EDM and flow training
    # step (launches in the CLI fits)
    ns = report["new_sites"]
    fwd_launches = {"edm": report["edm_serve"]["launches"],
                    "flow": report["flow_serve"]["launches"]}
    for (name, steps, _), req in zip(CACHING, report["serve"]["caching"]):
        if name in ("cached", "deep"):
            keys = -(-steps // 2)
            fwd_launches[name] = {k: v - keys * PER_FORWARD[k] for k, v in req["launches"].items()}
    for fam in ("edm", "flow", "cached", "deep"):
        for kname, v in ns[fam]["per_forward"].items():
            table.append(_table_row(f"{kname}_{fam}", kname, v, fwd_launches[fam][kname]))
    for fam in ("edm", "flow"):
        per_step = ns[f"{fam}_train"]["per_step"]
        for kname in ("group_norm_silu", "group_norm_silu_bwd", "attention"):
            table.append(_table_row(f"{kname}_{fam}_train", kname, per_step[kname],
                                    report[f"{fam}_fit"]["launches"][kname]))
    # the class-conditional and upsampler paths: K1/K3/K4 per guided call at
    # N = 2, 16, 32 (launches in the n = 1, 8, 16 requests of the CFG serve
    # phase) and per upsampler forward at n = 8 (launches in its
    # generate(low_res=)); K1/K2/K3 per labelled CFG training step at batch
    # 128 and per upsampler step at batch 32 (launches in their CLI fits)
    ck, sk = report["cfg_kernels"], report["sr_kernels"]
    for n in SERVE_BATCHES:
        for kname, v in ck["per_forward"][f"cfg_N{2 * n}"].items():
            table.append(_table_row(f"{kname}_cfg_N{2 * n}", kname, v,
                                    report["cfg_serve"]["launches_by_n"][n][kname]))
    for kname, v in sk["per_forward"].items():
        table.append(_table_row(f"{kname}_sr", kname, v,
                                report["sr_fit"]["generate"]["launches"][kname]))
    for tag, rec, fit_rec in (("cfg", ck, report["cfg_fit"]["fit"]),
                              ("sr", sk, report["sr_fit"]["fit"])):
        for kname in ("group_norm_silu", "group_norm_silu_bwd", "attention"):
            table.append(_table_row(f"{kname}_{tag}_train", kname,
                                    rec["train"]["per_step"][kname],
                                    fit_rec["launches"][kname]))
    # ADM and guidance: K3 per ADM-32 forward at n = 8 (launches in the four
    # default requests of its serve phase), per LitIDDPM(ADM) step at batch
    # 128 and per classifier step at batch 256 (launches in their 10-step CLI
    # fits), and per guided DDIM step at n = 8, generator and classifier
    # (launches in the guided DDIM-50 request)
    ak = report["adm_kernels"]
    for name, v, n_launch in (
            ("attention_adm", ak["per_forward"]["adm_n8"]["attention"],
             report["adm_serve"]["launches"]["attention"]),
            ("attention_adm_train", ak["train"]["per_step"]["attention"],
             report["adm_cli"]["fit"]["launches"]["attention"]),
            ("attention_classifier_train", ak["classifier_train"]["per_step"]["attention"],
             report["adm_cli"]["classifier_fit"]["launches"]["attention"]),
            ("attention_guided", ak["guided_step"]["per_step"]["attention"],
             report["adm_guidance"]["launches"]["attention"])):
        table.append(_table_row(name, "attention", v, n_launch))
    table += slice_rows(report, shapes)
    table += latent_rows(report)
    table += eval_rows(report)
    table += a12_rows(report)
    table += dist_rows(report)
    table += split_fit_rows(report, report["dist"]["ranks"], "spatial", SPLIT_GROUPS)
    table += split_fit_rows(report, report["quad"]["ranks"], "composed",
                            SPLIT_GROUPS // DIST_RANKS)
    report["kernels"] = table
    print("kernels launched on their paths and held against their plain versions: "
          + "; ".join(f"{k['name']} ({k['route']}, {k['source']}, replaces {k['replaces']}, "
                      f"{k['launches']} launches)" for k in table), flush=True)
    report["run_s"] = time.time() - _T0
    report["phase_s"] = phase_seconds()
    print("seconds each phase took: " + "; ".join(
        f"{i} {name.split(':')[0]} {s:.1f}" for i, (name, s) in enumerate(report["phase_s"], 1)),
        flush=True)
    if args.out:
        write_report(args.out, report)
    print(f"the whole run: {report['run_s']:.1f} s [{card}]", flush=True)
    print("(K1, K3, K4: launches in the four serve requests; ms, plain_ms, bound_ms and "
          "library_ms per UNet forward at batch 8, summed over the serving path's call sites. "
          f"K2: launches in the {FIT_STEPS} logged fit steps; times per training step at "
          f"batch {TRAIN_BATCH}, summed over its 45 call sites. *_f32, *_fp16: the default "
          f"harness in that dtype (K1 and K2 of group_norm.cu, K3 and K4 on the tensor cores, f32 "
          f"as 3xTF32); launches in the f32 phase's training step and DDIM step; times per "
          f"training step at batch {TRAIN_BATCH} (K1, K2, K3) and per UNet forward at "
          f"n = {BATCH} (K4), summed over their call sites. *_iddpm: the IDDPM UNet of "
          f"configs/iddpm/cifar10.yaml; K1, K3, K4 launches in the four default requests "
          f"and times per n = {BATCH} forward, K2 launches in the {FIT_STEPS} IDDPM fit steps "
          f"and times per batch-{TRAIN_BATCH} step. *_edm, *_flow: EDM's and flow's forwards, "
          f"launches in their default requests; *_cached, *_deep: the caching samplers' non-key "
          f"forwards, launches in the non-key steps of their n = {BATCH} requests; times per "
          f"n = {BATCH} forward. *_train: per batch-{TRAIN_BATCH} EDM or flow training step, "
          f"launches in the {FIT_STEPS}-step CLI fit, EDM's with its three sampling grids. "
          f"*_cfg_N<N>: per guided UNet call at batch N (labels and null token), launches in "
          f"the CFG serve request of n = N/2; *_sr: per upsampler forward at n = {BATCH}, "
          f"launches in its generate(low_res=); *_cfg_train: per labelled CFG step at batch "
          f"{TRAIN_BATCH}, launches in the {2 * CFG_CADENCE}-step CLI fit of {CFG_CONFIG}; "
          f"*_sr_train: per "
          f"upsampler step at batch {SR_BATCH}, launches in the {FIT_STEPS}-step CLI fit of "
          f"{SR_CONFIG}. attention_adm: per ADM-32 forward at n = {BATCH}, launches in its four "
          f"default requests; attention_adm_train, attention_classifier_train: per step at batch "
          f"{TRAIN_BATCH} and {CLASSIFIER_BATCH}, launches in the 10-step CLI fits of "
          f"{ADM_GUIDED} and {ADM_CLASSIFIER}; attention_guided: per ClassifierGuidedDDIM step at "
          f"n = {BATCH} (generator and classifier), launches in the guided "
          f"DDIM-{GUIDED_STEPS} request. attention_dit, attention_moe: per DiT-S/4 and MoE-DiT "
          f"forward at n = {BATCH} (12 sites), launches in their default flow requests; "
          f"*_train: per step at batch {TRAIN_BATCH}, launches in the {DIT_FIT_STEPS}-step CLI "
          f"fits. *_distill: per progressive-distillation step at batch {TRAIN_BATCH} (the "
          f"teacher's two forwards: K4 at N = {TRAIN_BATCH}, K1 at out_norm, K3; the student's "
          f"K1, K2, K3), launches in the driver's {DISTILL_ROUNDS} rounds of {DISTILL_STEPS} "
          f"steps. *_inpaint: per n = {BATCH} DDPM forward, launches in the RePaint run. "
          f"*_latent: per default latent UNet forward at n = {BATCH} on 16x16x4 latents, "
          f"launches in its served ddim and dpm requests; *_latent_train: per default "
          f"LitLatentDDPM step at batch {TRAIN_BATCH}, launches in its {TIMED_STEPS} timed and 3 "
          f"profiled steps; attention_latent_cfg_train: per step of {LATENT_DDPM_CONFIG}'s UNet, "
          f"launches in its uninterrupted {LATENT_FIT_STEPS}-step CLI fit; attention_latent_dit: "
          f"per latent DiT forward at n = {BATCH}, launches in its default flow request; "
          f"attention_latent_dit_train: per step at batch {TRAIN_BATCH}, launches in its "
          f"{LATENT_FIT_STEPS}-step CLI fit. *_eval: per DDIM-50 forward of a test batch at "
          f"N = {TRAIN_BATCH} (50 a batch), launches in the {EVAL_BATCHES} batches of the "
          f"save_fid_stats test of {DDIM_CONFIG}. *_lsun_train: per microbatch of {LSUN_CONFIG} "
          f"(batch 2, 256 px, remat), launches in its {LSUN_FIT_STEPS}-step CLI fit (8 "
          f"microbatches a step); *_lsun_sample: per sampling forward at n = 4, launches in that "
          f"fit's GenerateImage grid (100 DDPM forwards); *_in64_train: per step of "
          f"{IN64_CONFIG} at batch {TRAIN_BATCH}, launches in its {IN64_FIT_STEPS}-step CLI fit; "
          f"*_in64_serve: per forward at n = {BATCH}, launches in its DDIM-50 sample. "
          f"*_mesh_train: per step of a rank at batch {DIST_BATCH} ({DIST_CONFIG} on "
          f"{DIST_RANKS} ranks), launches in both ranks' data and fsdp fits; *_mesh_test: per "
          f"DDIM-50 forward of a test batch at N = {TRAIN_BATCH} (the *_eval shapes), launches "
          f"in both ranks' test; attention_expert_train: per step of a rank at batch {DIST_BATCH} "
          f"of {MOE_CONFIG} on {EXPERT_MESH}, launches in both ranks' expert fits; "
          f"*_tensor_train: per microbatch of a rank of {LSUN_CONFIG} on {TENSOR_MESH} (K1 and "
          f"K2 at its shard shapes, K3 whole), launches in both ranks' {TENSOR_STEPS}-step "
          f"tensor fits of {TENSOR_ACCUM} microbatches a step; attention_dit_tensor_train, "
          f"attention_moe_tensor_train: per step of a rank at batch {TRAIN_BATCH} of "
          f"{DIT_CONFIG} and {MOE_CONFIG} on {TENSOR_MESH} (K3 whole, phase 35's shapes), "
          f"launches in both ranks' {DIT_TENSOR_STEPS}-step tensor fits; "
          f"group_norm_silu_{{fwd_sums,fwd_apply,bwd_sums,bwd_dx}}_spatial_train: the split "
          f"K1/K2 entries (dmme_gn_silu_*) per microbatch of a rank of "
          f"{LSUN_CONFIG} on {SPATIAL_MESH} (phase 3's times at its H-shards), launches in both "
          f"ranks' {TENSOR_STEPS}-step spatial fits of {TENSOR_ACCUM} microbatches a step; "
          f"attention_spatial_train: K3 per such microbatch (whole, phase 47's shapes); "
          f"*_composed_train: the same per microbatch of a rank of {LSUN_CONFIG} on "
          f"{COMPOSED_MESH} (its rows of its channel shard: phase 3's times at C/2 channels in "
          f"G/2 groups), launches in the four ranks' fits)",
          flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
