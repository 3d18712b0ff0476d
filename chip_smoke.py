#!/usr/bin/env python3
"""Drive the port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each printed as one JSON object per line:

1. device: the card's name and count, and ``nvidia-smi``'s name and power limit;
2. build: the CUDA kernels of ``repro_torch`` built from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a, with the seconds taken, ptxas's register and
   shared-memory lines, and the tensor-core instructions in each source's SASS
   (kernel 7 must hold ``IGMMA``, kernel 6 ``BMMA``);
3. kernels: each kernel (both forms of the two training kernels) against its
   plain PyTorch version on the card at the main paths' shapes and at ragged
   ones, for exact equality (the datapath
   is integer: the tolerance is 0), then timed with CUDA events (``ms``, a
   call's wall share included) and by ``torch.profiler`` (``device_ms``, the
   device's share alone); for the table encode, ``hamming_packed`` and
   ``encode_unary_mxu``, one ``torch._int_mm`` call computing the same result,
   and for ``bundle_binarize`` one int32 ``index_add_``, is timed beside it as
   the library yardstick (the port never calls them); each bound is the largest of
   the bytes, the int32 operations and the popcounts over their rates (for the two
   packed-score kernels, 2*B*C*d binary operations at the binary tensor cores' rate,
   with the popcount count beside it, ``bound_ms_popc``), beside the earlier counts where they
   differ (``bound_ms_pr16``: popcounts as int32 operations; ``bound_ms_direct_form``); ``hamming_packed`` on both
   of its paths (``ops.packed_path``, and the tensor path forced at the warp path's
   shapes); the top-k store search's device time split into its scan and merge
   launches (``kernel_split``); and ``launch_floor``, the device time of a
   one-element PyTorch fill, the least a launch costs on the card;
4. slice and serve_plane: ``repro_torch.launch.serve_hdc``'s smoke at the JAX
   smoke's configuration (synth_mnist, d=8192, levels=16, 1024 training
   images, 256 requests one at a time through the ``ModelRegistry`` and its
   ``MicroBatcher`` in batches of 64, a hot reload to step 1 with the last 128
   queued), once with ``uhd_dynamic`` and once with ``uhd``, with every
   kernel's launch count read around each run (graph replays count the
   kernels they run), the class sums of both steps held against checksums
   from the JAX package, the served accuracy against the JAX package's, the
   packed path against ``HDCModel.predict``, ``search(k=3)[:, 0]`` against
   ``predict``, the ``uhd`` step-1 model converted to ``uhd_dynamic`` against
   itself, and (``serve_plane``) the batcher's request latency, img/s,
   occupancy, counters and graph replays, with each request's label against
   the eager step of the engine that served it;
4b. serve_pool: a ``ReplicaPool`` of two single-device replicas and one
   4-shard replica of the card, promoted to step 1 by ``hot_reload`` while a
   thread streams blocks of 8 requests: each block on one step, its labels
   against the single engine's;
4c. serve_http and serve_http_pool: ``repro_torch.launch.serve_http --smoke --d 8192``
   (uhd; 1024 training images, 256 requests through 4 client threads in binary
   blocks of 8, batch 32) over a real socket, once on one engine and once on a
   pool of 2 replicas: transport parity, 413, the watcher's mid-traffic
   promotion to the converted ``uhd_dynamic`` step 1 (its graph captured on the
   watcher's thread), every label against the step-0 engine and the JAX
   package's labels, the fit's class sums against JAX's, a raw ``:search?k=3``;
   request p50/p99, the queue, assembly, device and write stages' p50, img/s and
   the counters; on a machine with several cards the pool's replicas are
   whatever ``plan_executions`` gives over them (``network_plan``: on 4 cards,
   two 2-card sharded replicas, eager, scoring with ``hamming_packed``), and the
   kernels each network phase must and must not launch, and which engines must
   have replayed a graph, follow that plan; serve_online_uhd and
   serve_online_uhd_dynamic: ``serve_online --smoke --d 8192``, the learner
   training HTTP feedback on its own stream while the watcher promotes, the
   promoted sums and the accuracies before and after against JAX's, the
   learner's ingest, train and publish p50s; obs_agg:
   ``obs_agg --smoke --d 8192``, two endpoints (a 2-replica pool and one engine)
   aggregated over sockets; then ``network_phases``, their total seconds;
5. train: ``repro_torch.launch.train_hdc`` at its defaults (uhd, d=8192, 4096
   training images in batches of 2048, 1024 test images), its class sums
   against the JAX package's checksum and its labels against the JAX
   package's, and the checkpoint round trip;
6. item_memory: an ``ItemMemory`` of 65,536 random rows at d=8192 (64 MiB),
   after a delete and more adds, searched with k=8 against the plain version;
7. sharded: for each uHD encoder at D=8192 and at D=8160 (8160 / 4 = 2040 bits a
   shard, not whole words), and for the baseline encoder at D=8192 (kernels 7
   and 8 at 2048 columns a shard), ``partial_fit_sharded`` of the smoke's 512 + 512
   images on the card's own mesh and on a (data 2, model 4) mesh of one card,
   the class sums against the JAX package's checksums (D=8192) or the
   single-device ``partial_fit`` (D=8160); those models saved as 4 per-host
   checkpoint shards and the smoke's stream served from them through
   ``ShardedExecution`` on 1 and 4 shards (the ``hamming_packed`` kernel),
   labels and ``search(k=3)`` against the ``DeviceExecution`` engine and the
   accuracy against the JAX package's;
8. sharded_search: phase 6's 65,548 rows searched (k=8) through
   ``ShardedExecution`` on 1 and 4 shards, against the single-device search;
9. train_shard_map: ``train_hdc --shard-map --ckpt-shards 4`` at its defaults,
   its class sums against the JAX package's checksum, and the round trip;
9b. sharded_cards: the HDC paths on N = min(visible cards, 4) distinct cards
   (``sharded_cards_phase``): ``partial_fit_sharded`` on ``mesh_for()`` over them
   (and a (2, 2) mesh at N = 4) for the three encoders at D = 8192 against JAX's
   checksums, with every card of the mesh synchronised before the clock is read;
   those steps, and phase 7's per-host shards, served over the N cards against
   the one-card engine and JAX's accuracy; phase 8's store searched across them;
   a ``ReplicaPool`` of N single-card replicas, each with its graph on its own
   card, under a hot reload; the launches by card.  At N = 1 it runs the same
   code on the one card and says so;
10. slice_baseline: the serving smoke (and its serve_plane line) with the
   paper's baseline encoder, its class sums and served accuracy against the
   JAX package's (kernels 7, 8, 5);
11. slice_policy: the baseline smoke's step-1 model under non-default scoring
   policies (``class_binarize="none"``, ``binarize_query=True``,
   ``similarity="hamming"``), checkpointed and served through a
   ``ServingEngine``, its labels against the JAX package's;
12. train_baseline: ``train_hdc --encoder baseline --compare-baseline
   --baseline-iters 5`` at the launcher's defaults, each seed's class sums
   against the JAX package's checksum and its labels against JAX's (taken as
   each retrain is trained: the launcher keeps no retrained model), and the
   checkpoint round trip;
13. profile: ``torch.profiler`` over 16 steady predict batches of 64 for each
   encoder, on one device and on 4 shards (and, with several cards, phase 9b's
   engines over them, eager alone), the eager step
   (``engine.execution.predict``) beside the engine's CUDA-graph replay
   (``engine.predict``): wall ms a batch, device time a batch by kernel, and
   the device's idle share; a replay's device time also by CUDA events;
14. lm_serve: ``repro_torch.launch.serve``'s ``Server`` on qwen3-0.6b at full
   width (batch 4, prompt 32, gen 16, greedy, bf16), launches counted (none of
   the eight kernels may launch), held against the port's float32 forward on
   the CPU (teacher-forced) and, in float32, against the CPU's prefill; prefill
   ms, decode ms a step, tokens/s, the one-time weight cast and peak memory;
   then every arch's smoke config card against CPU (``lm_serve_phase``);
15. lm_train: ``repro_torch.launch.train`` on qwen3-0.6b at full width (batch 8,
   seq 256, remat, 8 loss chunks, float32 masters, bf16 compute) for 30 steps,
   launches counted (none of the eight kernels may launch), the loss falling;
   every smoke arch's train step card against CPU, the full-width loss and
   gradient norm card against CPU; step ms, tokens/s, device ms and idle
   share, mfu, peak memory; a 7.15 GB non-blocking checkpoint of the trained
   state, restored bit for bit; a SIGTERM'd smoke run resumed from its last
   completed step (``lm_train_phase``);
16. lm_mesh: the LM launchers one process a card under ``python -m
   torch.distributed.run --nproc-per-node N`` (N = min(cards, 4), NCCL) at
   qwen3-0.6b's full width: ``launch.train`` for 5 steps and ``launch.serve``
   at its defaults, every leaf a ``DTensor`` (on one card too), the losses held
   to lm_train's at the same seed and the tokens to the one-device ``Server``'s
   off near-ties; step ms, tokens/s and peak memory per rank
   (``lm_mesh_phase``);
17. examples: the nine ``repro_torch.examples`` on the card at their own sizes
   (``train_lm_e2e --preset 100m --steps 30``), launches counted a path each, their
   printed accuracies, labels and counts held against the JAX scripts' lines kept
   below (an accuracy of the cosine examples up to JAX's float32 near-ties), the
   LM examples launching none of the eight kernels, the 100m preset's loss
   falling; each example's seconds;
18. dryrun: ``repro_torch.launch.dryrun.run_cell`` on the production mesh of 256
   ``meta`` devices for qwen3-0.6b x train_4k, olmoe-1b-7b x decode_32k and
   recurrentgemma-2b x train_4k (the seconds, counted flops, per-device argument
   bytes, roofline terms; the collective bytes by kind, counted from the sharded
   step over a 256-rank ``fake`` group, and the host seconds of that count), in a
   child process with the card hidden, started before the LM phases and read
   here, and
   ``run_hdc()``: the 65,536 x 784 fit at D = 8192 on the card through kernel 3,
   its ms by CUDA events beside its bound, its class sums against the JAX
   package's checksum.

Then the ``kernels`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a card, or without the rest of the repository, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Class-sum checksums of the smoke configuration, computed by the JAX package
# on the CPU (sha256 of the (10, 8192) int32 class sums, little-endian); the
# same for encoder='uhd_dynamic' and encoder='uhd' (bit-identical encoders):
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import hashlib,numpy as np; \
#   from repro.core import HDCConfig,HDCModel; from repro.data import load_dataset; \
#   ds=load_dataset('synth_mnist',n_train=1024,n_test=256); \
#   c=HDCConfig(n_features=784,n_classes=10,d=8192,levels=16,encoder='uhd_dynamic'); \
#   m0=HDCModel.create(c).fit(ds.train_images[:512],ds.train_labels[:512]); \
#   m1=m0.partial_fit(ds.train_images[512:],ds.train_labels[512:]); \
#   [print(hashlib.sha256(np.asarray(m.class_sums).astype('<i4').tobytes()).hexdigest()) for m in (m0,m1)]"
JAX_CLASS_SUMS_SHA256 = (
    "85588503a413500219b41aaf77a3692899c31e4ba056c5a6fc3782237c122f1a",  # step 0
    "a1a6b68d2bf99548f4641ea18f8e84e2e7ef1c4a4607d7d5bc44fe416e06f3f7",  # step 1
)
# Served accuracy of `python -m repro.launch.serve_hdc --smoke --encoder E --d 8192
# --batch 64` (the JAX package on the CPU), the same for E = uhd_dynamic and uhd.
JAX_SERVED_ACCURACY = 0.8516

# `python -m repro.launch.serve_http --smoke --d 8192` (the JAX package on the CPU; uhd,
# 1024 training images, 256 requests): the step-0 fit's class sums (the same sums as
# JAX_CLASS_SUMS_SHA256's step 1), the sha256 of the 256 served labels (int32,
# little-endian) and their accuracy, from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import hashlib,numpy as np,jax.numpy as jnp; \
#   from repro.core import HDCConfig,HDCModel; from repro.core.hdc_model import predict_packed; \
#   from repro.data import load_dataset; ds=load_dataset('synth_mnist',n_train=1024,n_test=256); \
#   m=HDCModel.create(HDCConfig(n_features=784,n_classes=10,d=8192,levels=16,encoder='uhd')) \
#   .fit(ds.train_images,ds.train_labels); p=np.asarray(predict_packed(m,jnp.asarray( \
#   ds.test_images),m.pack())).astype('<i4'); \
#   print(hashlib.sha256(np.asarray(m.class_sums).astype('<i4').tobytes()).hexdigest()); \
#   print(hashlib.sha256(p.tobytes()).hexdigest()); print((p==ds.test_labels).mean())"
# (the launcher prints "served accuracy over 256 requests: 0.8789").
JAX_HTTP_SHA256 = "a1a6b68d2bf99548f4641ea18f8e84e2e7ef1c4a4607d7d5bc44fe416e06f3f7"
JAX_HTTP_LABELS_SHA256 = "db195f41c1108d006f6faa261da290395b11e7bc1276fbeeae90556fdfa0a488"
JAX_HTTP_ACCURACY = 0.87890625

# `python -m repro.launch.serve_online --smoke --d 8192` (the JAX package on the CPU; 256
# base images, 1024 fed back, 256 held out), the same for encoder 'uhd' and 'uhd_dynamic':
# the promoted class sums (= the base model's partial_fit of the whole feedback stream)
# and the held-out accuracy before and after, from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import hashlib,numpy as np,jax.numpy as jnp; \
#   from repro.core import HDCConfig,HDCModel; from repro.core.hdc_model import predict_packed; \
#   from repro.data import load_dataset; ds=load_dataset('synth_mnist',n_train=1280,n_test=256); \
#   b=HDCModel.create(HDCConfig(n_features=784,n_classes=10,d=8192,levels=16,encoder='uhd')) \
#   .fit(ds.train_images[:256],ds.train_labels[:256]); \
#   o=b.partial_fit(ds.train_images[256:],ds.train_labels[256:]); \
#   acc=lambda m:(np.asarray(predict_packed(m,jnp.asarray(ds.test_images),m.pack()))==ds.test_labels).mean(); \
#   print(hashlib.sha256(np.asarray(o.class_sums).astype('<i4').tobytes()).hexdigest(),acc(b),acc(o))"
# (the launcher prints "accuracy 0.8828 -> 0.9102").
JAX_ONLINE_SHA256 = "37eb71461052a164fce95ee1278db4435759d7d51dc2cd8378ed6dd3358920fc"
JAX_ONLINE_ACCURACY = (0.8828125, 0.91015625)

# `python -m repro.launch.train_hdc` at its defaults (the JAX package on the CPU):
# the class sums' sha256, the accuracy and the 1024 predicted labels, from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import hashlib,numpy as np,jax.numpy as jnp; \
#   from repro.core import HDCConfig,HDCModel; from repro.data import load_dataset; \
#   ds=load_dataset('synth_mnist',n_train=4096,n_test=1024); \
#   m=HDCModel.create(HDCConfig(n_features=784,n_classes=10)).fit_batches( \
#   (ds.train_images[i:i+2048],ds.train_labels[i:i+2048]) for i in (0,2048)); \
#   p=np.asarray(m.predict(jnp.asarray(ds.test_images))); \
#   print(hashlib.sha256(np.asarray(m.class_sums).astype('<i4').tobytes()).hexdigest()); \
#   print((p==ds.test_labels).mean()); print(''.join(map(str,p.tolist())))"
# The training set holds the pixel whose level depends on quantizing as the
# jitted JAX paths do (image 533, pixel 471, 239.06248 -> level 15).
JAX_TRAIN_SHA256 = "19164c5d78158f7645f974b9de61ba3790efb7f31407ff98042168951992b452"
JAX_TRAIN_ACCURACY = 0.8984375
JAX_TRAIN_LABELS = (
    "4752626423573653133133200319873696305856444042547863896538243598"
    "4717099993809375441185567780495680416092157175018916069499938373"
    "4167861511135921108798152388812609169060387669113551050028340802"
    "2446429833851767044503818197241776720351632630135665389046496407"
    "1139363659435031183512564013589553969738083857517786903792233454"
    "7471904655547088297884031761340366436264858578001587787653452079"
    "9745981150161183512905580346733881420701818385710121181076943123"
    "4128394971996995978118743210275575117982232130480122113895469376"
    "0511732698973711641916865967690134183058445247718334338076686735"
    "7746931472112646748518027119169400819029391922768936371495294415"
    "9751548579454835438833063808595283460048052868524037201253102993"
    "7281912365559738386343154739316150239767334840848439745469680915"
    "1250658777015534244457256108371428350157529752014099328354291679"
    "7168413052182820142093193398382455016901793131070924274896050435"
    "4074217129512645985550445757614066571557931961249207181463563502"
    "5293901159051643097773730819167985141946312044333748570673799600"
)

# The serving smoke with encoder='baseline' (the JAX package on the CPU): the class
# sums' sha256 at both steps and the served accuracy, from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import hashlib,numpy as np,jax.numpy as jnp; \
#   from repro.core import HDCConfig,HDCModel; from repro.core.hdc_model import predict_packed; \
#   from repro.data import load_dataset; ds=load_dataset('synth_mnist',n_train=1024,n_test=256); \
#   c=HDCConfig(n_features=784,n_classes=10,d=8192,levels=16,encoder='baseline'); \
#   m0=HDCModel.create(c).fit(ds.train_images[:512],ds.train_labels[:512]); \
#   m1=m0.partial_fit(ds.train_images[512:],ds.train_labels[512:]); \
#   [print(hashlib.sha256(np.asarray(m.class_sums).astype('<i4').tobytes()).hexdigest()) for m in (m0,m1)]; \
#   p=np.concatenate([np.asarray(predict_packed(m,jnp.asarray(x),m.pack())) for m,x in \
#   ((m0,ds.test_images[:128]),(m1,ds.test_images[128:]))]); print((p==ds.test_labels).mean())"
# (`python -m repro.launch.serve_hdc --smoke --encoder baseline --d 8192 --batch 64` prints
# the same accuracy, 0.8633.)
JAX_BASELINE_SHA256 = (
    "9042c4c3c54926fc05a71aa95b13a4f85002822d40d9ae05499c8c5ad57fdbba",  # step 0
    "ae003c86330dcaa941561a30aa2f11f1055f4b37d62520f4703f2f7398d74f34",  # step 1
)
JAX_BASELINE_SERVED_ACCURACY = 0.86328125

# The serving smoke's step-1 baseline model under non-default scoring policies (the
# JAX package on the CPU): its predict_packed (= predict, hamming) labels of the 256
# test images and their accuracy, from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import numpy as np,jax.numpy as jnp; \
#   from repro.core import HDCConfig,HDCModel; from repro.core.hdc_model import predict_packed; \
#   from repro.data import load_dataset; ds=load_dataset('synth_mnist',n_train=1024,n_test=256); \
#   c=HDCConfig(n_features=784,n_classes=10,d=8192,levels=16,encoder='baseline', \
#   class_binarize='none',binarize_query=True,similarity='hamming'); \
#   m=HDCModel.create(c).fit(ds.train_images[:512],ds.train_labels[:512]) \
#   .partial_fit(ds.train_images[512:],ds.train_labels[512:]); x=jnp.asarray(ds.test_images); \
#   p=np.asarray(predict_packed(m,x,m.pack())); assert (p==np.asarray(m.predict(x))).all(); \
#   print((p==ds.test_labels).mean()); print(''.join(map(str,p.tolist())))"
JAX_POLICY = dict(class_binarize="none", binarize_query=True, similarity="hamming")
JAX_POLICY_ACCURACY = 0.85546875
JAX_POLICY_LABELS = (
    "5072570471867376405388822623100675813798368454582964212317852141"
    "7242618445142432272982610817810596853235485367957370955905349196"
    "7630869225524913645788943133569573600775037209729254374453587974"
    "2146876682408769209046913220190215187336405294243451836833113602"
)

# `python -m repro.launch.train_hdc --encoder baseline --compare-baseline` at its defaults
# (the JAX package on the CPU): for each seed i of baseline_iterative_search (seed 0 is
# also the --encoder baseline model), the class sums' sha256, the accuracy and the 1024
# predicted labels, from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "import hashlib,numpy as np,jax.numpy as jnp; \
#   from repro.core import HDCConfig,HDCModel; from repro.data import load_dataset; \
#   ds=load_dataset('synth_mnist',n_train=4096,n_test=1024); \
#   ms=[HDCModel.create(HDCConfig(n_features=784,n_classes=10,encoder='baseline',seed=s)) \
#   .fit_batches((ds.train_images[i:i+2048],ds.train_labels[i:i+2048]) for i in (0,2048)) \
#   for s in range(5)]; ps=[np.asarray(m.predict(jnp.asarray(ds.test_images))) for m in ms]; \
#   [print(hashlib.sha256(np.asarray(m.class_sums).astype('<i4').tobytes()).hexdigest(), \
#   (p==ds.test_labels).mean(), ''.join(map(str,p.tolist()))) for m,p in zip(ms,ps)]"
JAX_BASELINE_TRAIN_SHA256 = (
    "944e627dfff1252464deb4bffb5fd194a09a4e7d68c799871787e820c14d29c9",
    "c8f7880dc7604a9369bf62503c5a4f260662f7222960d13c4739acaba1ebb6e6",
    "128150d2b2cfbb21cd17f9717be2e74e5d39379dfe19310f4005ee6220d5268d",
    "d7d1a94430c60c8297beb62321e6af8e3bc0569af654c5ac85fcf56fe3722ace",
    "1de8c531cd581ae93be6fca2678929a5c67662947fb0562a6c576b7c27882abe",
)
JAX_BASELINE_TRAIN_ACCURACY = (0.8740234375, 0.8740234375, 0.8798828125, 0.880859375, 0.875)
JAX_BASELINE_TRAIN_LABELS = {
    0: (
        "4782626422573753133133200319963696305856444042547861893528263598"
        "4717099993809375441185567780495680416092177175018916069499938373"
        "4167869511135721108798152388812706169060387769113551350028340802"
        "2443429832851767044503898197241776720251632630135665289046496407"
        "1139363659435031182512564013589853969738082857517786903792233454"
        "7471904655547088297884031761340366436264858578001587787653452079"
        "9744981950161183512915580346733881420701818375710121181070943123"
        "4128394971996995978118743210275575117972262130680122113895469376"
        "0511732698973711649916865967693134183058445247718336638076686735"
        "7746931472112646748518027119169400819029391922768936371495294415"
        "9751568579454835438833063808595283660048152868534027201253602996"
        "7281912365559738386343154739316150239767334840848429745469610915"
        "1250658777015536244457256108371428350157529352014099228354291679"
        "7168413052182830142093193398282455016901793131070924274896050635"
        "4074217129592655985550445757414066571557931961249207981463563502"
        "5296901351851643097773730819167985141946312044333748570673799600"
    ),
    1: (
        "4782626423573653133133300319763696305856444042547863896528263598"
        "4717099992809375441175567780495680416092177175018916069499938373"
        "4167861511125721108798152388812609169060387769113551350027340802"
        "2446429833851767044503817167241776720351632630135665389046416407"
        "1169363659435031184522564013589753169738022857517786903792233454"
        "7471904655567088297884031761340366436264858578001587787653452079"
        "9745981950161183512915580346733881420701818375710121181070943123"
        "4128394971996995978118743210275575117972262130680122113895469376"
        "0521732698973711641916865967693134183058445247718334638076696725"
        "7746931472112646748518027119169400819029391922768926371495394415"
        "9759568579454835438833063808595283660048252868534037201253602996"
        "7281912365559738386343154739316150239767334840848421745469610915"
        "1250658777015536244457256108371428350157529352014099228354291679"
        "7168413052182820142093193398282455016903793131070924274896050635"
        "4074217129592655985550445757414066571557921961249207181463563502"
        "5293901359851643097773730819167985141946392044333748570673799600"
    ),
    2: (
        "4772626423573653133133300319973696305876444042547863896528263598"
        "4717099992809375441185567780495680416092177175018916069499938373"
        "4167861511135721108798152388812709169060387769113551350028340802"
        "2446429832851767044503818197241776720251632630135665389046496407"
        "1199363659435031183522564013589853969738032857517786903792233454"
        "7471904655547088297884031761340366436264858578001587787653452079"
        "9745981150161183512915580746733881420701818345710121181070963123"
        "4128394971996995978118743210275575117972262130680123113895469376"
        "0521732698973711641916865977693134183058445247718334738076686725"
        "7746931472112646748518027119169400819029391922768926371495394415"
        "9759568579454835438833063808595283660048152868534037201253602993"
        "7281112365559738386343154739316150239767334840848429745469610915"
        "1250658777015536244457256108371428350157529352014099328354291679"
        "7168412052182820142093193398382455016903793131070924274896050635"
        "4074217139592655985550445757416066571557931961249207981463563502"
        "5293901359851643097773730819167985141946392044333748570673799600"
    ),
    3: (
        "4782626423573653133133200319763696305856444042547863893528263598"
        "4717099992809375441185567780495680416093177175018916069499938373"
        "4167861511135721108798152388812609169060387769113551650025340802"
        "2446429833851767044503817197241776720351632630135665389046496407"
        "1199363659435031182522564013589553169738032857517786903792233454"
        "7471904655547088297884031761340366436264858578001587787653452079"
        "9744981950161183512915580346733881420701818345710121181070943123"
        "4128394971996995978118743210275575117972262130680122113895469376"
        "0521732698973711649916865967690134183058445247718336738076686725"
        "7746931472112646748518027119169400819021391922768936371495394415"
        "9759568579454835468833063808595283660048152868534027301253602996"
        "7281912365559738386343154739316150239767334840848429745469610915"
        "1250658777015536244457256108371428350157529352014099328354291679"
        "7168413052182820142092193398382455016901793131070924274896050635"
        "4074217129592655985550445757614066571557931961249207981463563502"
        "5296901359851643097773730819167985141946312044333748570673799600"
    ),
    4: (
        "4782626423573753133133200319963696305856444042547863893528263598"
        "4717099992809375441185567780495680416092177175018916069499938373"
        "4167861511135721108798152388812609169060387769113551350025340802"
        "2446429833851767044503815107241776720251632630135665389046496407"
        "1199363659435031184522564013589853169738032857517786903792233454"
        "7471904655547088297884031761340366436264858578001587787653452079"
        "9745981950161183512915580346733881420701818375710121281070943123"
        "4928394971996995978118743210275577117972262130680123113895469376"
        "0521732698973711649116865977693134183058445247718334638076686725"
        "7746931472112646748518027119169400819029391922768926371495394415"
        "9759568579454835468833063808595283660048152868534037201253602996"
        "7281112365559738386343154739316150239767334840848429745469610915"
        "1250658777015536244457256108371428350157529352014099228354291679"
        "7168413052182820142093193398382455016903793131070924274896050635"
        "4074217129592655985550445757416066571557921961249207181463563502"
        "5296901359051643097773730819167985141946392044333748570653799600"
    ),
}


def _roofline():
    """This checkout's ``repro_torch.analysis.roofline``, loaded from its file
    (a module that imports nothing at import), so that the H100 terms of the
    bounds below are the port's own, and so that a ``repro_torch`` of another
    commit ahead on ``sys.path`` (``chip_ab.py``) does not change them."""
    import importlib.util

    path = ROOT / "src" / "repro_torch" / "analysis" / "roofline.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass looks its module up there
    spec.loader.exec_module(mod)
    return mod


# Peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet; see the
# roofline module's docstring): HBM bytes, int32 compare-count operations on
# the CUDA cores, popcounts on their own pipe, and the int8 tensor cores' dense
# rate (a multiply and an add of the int8 product count as 2 ops).
_RL = _roofline()
HBM_BYTES_PER_S = _RL.HBM_BW
INT32_OPS_PER_S = _RL.INT32_OPS_PER_S
POPC_PER_S = _RL.POPC_PER_S
INT8_TC_OPS_PER_S = _RL.INT8_TC_OPS_PER_S
# the binary products of kernels 5 and 6 (mma.sync m16n8k256 .b1, BMMA), as measured on
# an H100 SXM (PERF.md §6): 0.587 MMAs of 2 * 16 * 8 * 256 operations a clock an SM, on
# 132 SMs at 1,980 MHz, 10.05 P binary operations/s
BMMA_OPS_PER_S = 0.587 * 2 * 16 * 8 * 256 * 132 * 1.98e9

KERNELS = {
    "encode_bundle": dict(
        source="src/repro_torch/kernels/csrc/encode_bundle.cu",
        replaces="src/repro/kernels/encode_bundle.py:55",
    ),
    "encode_bundle_dynamic": dict(
        source="src/repro_torch/kernels/csrc/encode_bundle.cu",
        replaces="src/repro/kernels/encode_bundle.py:121",
    ),
    "fit_bundle": dict(
        source="src/repro_torch/kernels/csrc/encode_bundle.cu",
        replaces="src/repro/kernels/encode_bundle.py:187",
    ),
    "fit_bundle_dynamic": dict(
        source="src/repro_torch/kernels/csrc/encode_bundle.cu",
        replaces="src/repro/kernels/encode_bundle.py:261",
    ),
    "hamming_topk": dict(
        source="src/repro_torch/kernels/csrc/hamming_topk.cu",
        replaces="src/repro/kernels/hamming_topk.py:80",
    ),
    "hamming_packed": dict(
        source="src/repro_torch/kernels/csrc/hamming_packed.cu",
        replaces="src/repro/kernels/hamming_packed.py:34",
    ),
    "encode_unary_mxu": dict(
        source="src/repro_torch/kernels/csrc/encode_unary_mxu.cu",
        replaces="src/repro/kernels/encode_unary_mxu.py:43",
    ),
    "bundle_binarize": dict(
        source="src/repro_torch/kernels/csrc/bundle_binarize.cu",
        replaces="src/repro/kernels/bundle_binarize.py:45",
    ),
}
# the shape each kernel's entry of the kernels line reports (others follow it)
MAIN_SHAPE = {
    "encode_bundle": {"B": 64, "H": 784, "D": 8192, "levels": 16, "table": "int8"},
    "encode_bundle_dynamic": {"B": 64, "H": 784, "D": 8192, "skip": 1, "levels": 16},
    "fit_bundle": {"B": 512, "H": 784, "D": 8192, "C": 10, "table": "int8"},
    "fit_bundle_dynamic": {"B": 512, "H": 784, "D": 8192, "C": 10, "skip": 1},
    "hamming_topk": {"B": 64, "C": 10, "D": 8192, "k": 1},
    "hamming_packed": {"B": 64, "C": 10, "D": 8192},
    "encode_unary_mxu": {"B": 64, "K": 13344, "D": 8192, "operands": "baseline"},
    "bundle_binarize": {"B": 2048, "C": 10, "D": 8192, "binarize": False},
}


# device time and bound of each kernel by the wrapper's shape key (ops.LAUNCH_SHAPES), and
# the launches of each path by shape key
BY_KEY: dict[str, dict[str, dict]] = {}
PATH_SHAPES: dict[str, dict[str, dict[str, int]]] = {}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def launch_key(torch, ops, name: str, fn) -> str:
    """The shape key that kernel `name`'s wrapper records for one call of fn."""
    ops.reset_launches()
    fn()
    torch.cuda.synchronize()
    (key,) = ops.LAUNCH_SHAPES[name]
    return key


SASS_OPS = ("GMMA", "IGMMA", "HGMMA", "IMMA", "BMMA")


def sass_counts(_build) -> dict[str, dict[str, int]]:
    """Tensor-core instructions in the built library's SASS (``cuobjdump
    -sass``), by kernel source: warpgroup MMA (the ``*GMMA`` family,
    ``IGMMA`` for integers, ``HGMMA`` for halves), ``IMMA`` (what
    ``mma.sync`` on integers compiles to) and ``BMMA`` (``mma.sync`` on
    single bits)."""
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    lib = _build.BUILD_ROOT / _build.source_hash() / "libuhd_kernels.so"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = next((k for k in ("encode_unary_mxu", "encode_bundle", "hamming_topk",
                                   "hamming_packed", "bundle_binarize") if k in name), "other")
            counts.setdefault(fn, {op: 0 for op in SASS_OPS})
        elif fn is not None:
            for op in SASS_OPS:
                counts[fn][op] += f"{op}." in line or f"{op} " in line
    return counts


def time_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds of fn over `iters` launches, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int, rows: list | None = None):
    """Device time per call of fn: the self time of the kernels and copies
    it ran over `iters` calls under ``torch.profiler``, a call's share.
    Unlike ``time_ms`` it leaves out the host's share of a call, which is
    what a launch-bound kernel's event time measures.  Each profile traces
    one warm-up call first and drops it (the profiler's schedule).  The
    profiler can miss launches: every call of fn runs the same kernels, so
    each device row should count n * `iters` launches; a row within a tenth
    of a call's worth of that (n >= 1) is priced as n launches at its mean,
    and a profile with a row further off, or with no row, is not used.  Up
    to six profiles are taken until three are used, and the median of their
    totals is returned, or "not measured" where none was used.  With `rows`,
    appends each device row's name, ms a call and calls a call in the median
    profile (or in the last one, marked ``partial``) to it."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def priced(found):
        per_call = [max(1, round(n / iters)) for _, _, n in found]
        if not found or any(abs(n - c * iters) > iters // 10 for (_, _, n), c in zip(found, per_call)):
            return None
        return [(k, t / n * c, n / iters) for (k, t, n), c in zip(found, per_call)]

    fn()
    torch.cuda.synchronize()
    used, last = [], []
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
        found = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.self_device_time_total > 0 and not e.key.startswith("ProfilerStep")]
        last = [(k, t / iters, n / iters) for k, t, n in found]
        if (p := priced(found)) is not None:
            used.append(p)
            if len(used) == 3:
                break
    best = sorted(used, key=lambda p: sum(t for _, t, _ in p))[len(used) // 2] if used else last
    if rows is not None:
        rows.extend({"name": k[:70], "ms": t / 1e3, "calls": c, **({} if used else {"partial": True})}
                    for k, t, c in sorted(best, key=lambda r: -r[1]))
    return sum(t for _, t, _ in best) / 1e3 if used else "not measured"


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = INT32_OPS_PER_S,
             n_popc: float = 0) -> tuple[float, str]:
    """The least time for the work, in ms: the largest of the bytes over the memory
    rate, the operations over their rate, and the popcounts over the popcount pipe's."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, max(n_ops / ops_per_s, n_popc / POPC_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def popc_bound_ms(n_bytes: float, n_ops: float, n_popc: float) -> float:
    """The packed-score kernels' bound on the CUDA cores: an XOR and an add a
    word pair at the int32 rate and a popcount at the popcount pipe's."""
    return bound_ms(n_bytes, n_ops, n_popc=n_popc)[0]


def encode_dynamic_ops(b: int, h: int, d: int, nb: int) -> tuple[int, int]:
    """The integer operations and popcounts encode_bundle_dynamic's kernel issues:
    where the thresholds have at most 7 bits it counts four rows in the bytes of one
    word with an add, a shift, a mask and an accumulate (4 int32 ops a word, B*H*D/4
    words); wider thresholds take a compare and an add a row (2*B*H*D).  Plus nb
    popcounts a generated S[h, d], nb the bits the direction matrix uses, once
    for each 64-row block."""
    per_row = 1 if nb <= 7 else 2
    return per_row * b * h * d, h * d * nb * -(-b // 64)


def encode_splits(b: int, h: int, d: int) -> int:
    """The H splits of an encode launch (``encode_splits`` in encode_bundle.cu):
    doubled while the grid of 128-column, 64-row blocks stays within 4 * 132
    blocks, up to 16, each split holding at least 8 features."""
    tiles = -(-d // 128) * -(-b // 64)
    splits = 1
    while splits < 16 and tiles * splits * 2 <= 4 * 132 and 2 * splits * 8 <= h:
        splits *= 2
    return splits


def encode_table_ops(torch, b: int, tab) -> int:
    """The int32 operations encode_bundle's kernel issues on this table: for each
    32-feature chunk of each H split and each 128-column block, B*hn*cols word
    operations where the chunk's staged entries all lie in [0, 127] (the byte
    lanes: an add, shift, mask and accumulate a word of four rows), else
    2*B*hn*cols (a compare and an add a row)."""
    h, d = tab.shape
    splits = encode_splits(b, h, d)
    per = -(-h // splits)
    wide = ((tab < 0) | (tab > 127)).to(torch.int8)
    wide = torch.nn.functional.pad(wide, (0, -d % 128)).view(h, -1, 128)
    cols = torch.full((wide.shape[1],), 128, dtype=torch.int64, device=tab.device)
    cols[-1] = d - 128 * (wide.shape[1] - 1)
    n = 0
    for split in range(splits):
        hb0 = min(h, split * per)
        hb1 = min(h, hb0 + per)
        for h0 in range(hb0, hb1, 32):
            hn = min(32, hb1 - h0)
            lanes = wide[h0:h0 + hn].amax(dim=(0, 2)) == 0
            n += b * hn * int((cols * torch.where(lanes, 1, 2)).sum())
    return n


def library_int_mm(torch, results, got, x, tab, levels, shape) -> None:
    """Time ``torch._int_mm`` computing the table encode's counts exactly: the
    JAX package's unary_matmul form (``core/encoding.py:94``), the inclusive
    thermometer of x, (B, H*levels) int8, times the one-hot of S,
    (H*levels, D) int8, with hv = 2*count - H.  The operands are built
    outside the timed region; the result must equal the kernel's."""
    b, h = x.shape
    d = tab.shape[1]
    v = torch.arange(levels, device=x.device, dtype=torch.int32)
    u = (v[None, None, :] <= x[:, :, None]).to(torch.int8).reshape(b, h * levels)
    o = (tab.to(torch.int32)[:, None, :] == v[None, :, None]).to(torch.int8)
    o = o.reshape(h * levels, d)
    counts = torch._int_mm(u, o)
    torch.cuda.synchronize()
    equal = torch.equal(2 * counts - h, got)
    ms = time_ms(torch, lambda: torch._int_mm(u, o), 50)
    emit("library_time", kernel="encode_bundle", call="torch._int_mm", shape=shape, ms=ms,
         equal=equal, onehot_bytes=o.numel())
    if not equal:
        raise AssertionError("torch._int_mm's counts differ from encode_bundle's")
    results["encode_bundle"]["timed"][json.dumps(shape, sort_keys=True)]["library_ms"] = ms


def library_packed_int_mm(torch, results, got, bits_q, bits_r, shape) -> None:
    """Time ``torch._int_mm`` computing the packed scores exactly: the ±1
    int8 sign vectors, (B, D) times (D, C), with C padded to a multiple of
    16 for its shape rules.  The operands are built outside the timed
    region; the result must equal the kernel's."""
    c = bits_r.shape[0]
    pad = -c % 16
    a = bits_q.to(torch.int8) * 2 - 1
    rows = torch.cat([bits_r, bits_r.new_zeros((pad, bits_r.shape[1]))]) if pad else bits_r
    b = (rows.to(torch.int8) * 2 - 1).t().contiguous()
    scores = torch._int_mm(a, b)[:, :c]
    torch.cuda.synchronize()
    equal = torch.equal(scores, got)
    ms = time_ms(torch, lambda: torch._int_mm(a, b), 20)
    emit("library_time", kernel="hamming_packed", call="torch._int_mm", shape=shape, ms=ms,
         equal=equal, padded_c=c + pad)
    if not equal:
        raise AssertionError("torch._int_mm's scores differ from hamming_packed's")
    results["hamming_packed"]["timed"][json.dumps(shape, sort_keys=True)]["library_ms"] = ms


def exact(torch, got, want) -> tuple[bool, int]:
    """Whether each tensor of got equals its twin in want, and the largest
    absolute difference."""
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    return equal, err


def kernel_phase(torch, ops, ref, sobol, unary, encoding, prng) -> dict[str, dict]:
    """Each kernel against its plain version; times at the main paths' shapes."""
    import numpy as np

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results: dict[str, dict] = {}

    def rand_x(b, h, levels=16):
        return torch.randint(0, levels + 1, (b, h), generator=gen, device=dev, dtype=torch.int32)

    def direction(h, levels=16, dtype=None):
        dirs = sobol.quantized_direction_matrix(h, levels, seed=0)
        return torch.from_numpy(dirs.astype(dtype or dirs.dtype)).to(dev)

    def table(h, d, levels=16):
        t = sobol.sobol_table_for_features(h, d, levels, seed=0)
        return torch.from_numpy(t.astype("int8" if levels <= 127 else "int32")).to(dev)

    def _dtype(t):
        return str(t.dtype).split(".")[-1]

    def check(name, got, want, shape, timed=None, direct_ops=None, popc=0, pr16_ops=None,
              popc_form=None, by_key=True):
        equal, err = exact(torch, got, want)
        emit("kernel_check", kernel=name, shape=shape, equal=equal, max_abs_err=err)
        if not equal:
            raise AssertionError(f"{name} disagrees with its plain version at {shape}")
        r = results.setdefault(name, {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if timed is not None:
            kernel_fn, plain_fn, n_bytes, n_ops, *rate = timed
            ms = time_ms(torch, kernel_fn, 50)
            rows: list = []
            dev_ms = device_ms(torch, kernel_fn, 20, rows)
            plain = time_ms(torch, plain_fn, 3)
            b_ms, b_by = bound_ms(n_bytes, n_ops, *rate, n_popc=popc)
            share = b_ms / dev_ms if isinstance(dev_ms, float) else "not measured"
            extra = {}
            if direct_ops is not None:  # the direct form's count: a compare and an add a row
                extra["bound_ms_direct_form"] = bound_ms(n_bytes, direct_ops)[0]
            if pr16_ops is not None:  # PR 16's count: a popcount as one int32 operation
                extra["bound_ms_pr16"] = bound_ms(n_bytes, pr16_ops)[0]
            if popc_form is not None:  # XOR, add and popcount on the CUDA cores
                extra["bound_ms_popc"] = popc_bound_ms(n_bytes, *popc_form)
            key = launch_key(torch, ops, name, kernel_fn)
            emit("kernel_time", kernel=name, shape=shape, key=key, ms=ms, device_ms=dev_ms,
                 plain_ms=plain, bound_ms=b_ms, bound_by=b_by, bound_share=share,
                 device_rows=rows[:4], **extra)
            r.setdefault("timed", {})[json.dumps(shape, sort_keys=True)] = dict(
                ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                bound_share=share, shape=shape, key=key, device_rows=rows, **extra,
            )
            if by_key:
                BY_KEY.setdefault(name, {})[key] = dict(device_ms=dev_ms, bound_ms=b_ms,
                                                        bound_by=b_by, **extra)

    # -- encode_bundle: the serving batch at each D-shard width, train_hdc's
    #    evaluate batch, an int8 table with entries in [-128, 127] and x outside
    #    [0, 128] (the int32 compares in some chunks, byte lanes in others), then
    #    ragged cases, one with an int32 table (levels=256) ---------------------
    for b, h, d, levels, full in [(64, 784, 8192, 16, False), (64, 784, 2048, 16, False),
                                  (64, 784, 2040, 16, False), (1024, 784, 8192, 16, False),
                                  (64, 784, 2040, 16, True), (37, 100, 1000, 16, False),
                                  (33, 113, 257, 256, False)]:
        x, tab = rand_x(b, h, levels), table(h, d, levels)
        if full:
            # negative entries in the first 300 rows only: the chunks of the later
            # rows keep the byte lanes
            tab = torch.randint(0, 128, (h, d), generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8)
            tab[:300:3, ::5] = torch.randint(-128, 0, tab[:300:3, ::5].shape, generator=gen,
                                             device=dev, dtype=torch.int32).to(torch.int8)
            x = torch.randint(-300, 300, (b, h), generator=gen, device=dev, dtype=torch.int32)
            x[1::3, ::4] = torch.randint(-2**31, 2**31 - 1, x[1::3, ::4].shape, generator=gen,
                                         device=dev, dtype=torch.int32)  # any int32 x
        k_fn = lambda: ops.encode_bundle(x, tab)  # noqa: E731
        p_fn = lambda: ref.encode_bundle(x, tab)  # noqa: E731
        got = k_fn()
        torch.cuda.synchronize()
        shape = dict(B=b, H=h, D=d, levels=levels, table=str(tab.dtype).split(".")[-1],
                     **({"entries": "negative_int8"} if full else {}))
        n_bytes = b * h * 4 + h * d * tab.element_size() + b * d * 4
        # the bound counts what the body issues (byte lanes where a chunk allows them);
        # the compare count, a compare and an add a row, stands beside it
        check("encode_bundle", [got], [p_fn()], shape,
              (k_fn, p_fn, n_bytes, encode_table_ops(torch, b, tab)) if b in (64, 1024) else None,
              direct_ops=2 * b * h * d, by_key=not full)
        if b == 64 and d == 8192:
            library_int_mm(torch, results, got, x, tab, levels, shape)

    # -- fit_bundle: the histogram form (int8 tables) at the smoke's fit batch,
    #    train_hdc's batch and the D-shard batches; the direct form (the same
    #    entries as int32) at the smoke's batch; then a full-range int8 table
    #    (entries in [-128, 127], x outside every row's range, labels -1 and C)
    #    on both forms, and ragged shapes on both forms, C = 48 and C = 50 ------
    for b, h, d, c, wide, full in [
        (512, 784, 8192, 10, False, False), (2048, 784, 8192, 10, False, False),
        (256, 784, 2048, 10, False, False), (256, 784, 2040, 10, False, False),
        (512, 784, 8192, 10, True, False), (256, 784, 2040, 10, False, True),
        (256, 784, 2040, 10, True, True), (37, 100, 1000, 10, False, False),
        (37, 100, 1000, 10, True, False), (300, 49, 300, 48, False, True),
        (33, 113, 257, 26, True, True), (37, 100, 1000, 50, False, False),
    ]:
        x, tab = rand_x(b, h), table(h, d)
        labels = torch.randint(0, c, (b,), generator=gen, device=dev, dtype=torch.int32)
        if full:
            tab = torch.randint(-128, 128, (h, d), generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8)
            x = torch.randint(-300, 300, (b, h), generator=gen, device=dev, dtype=torch.int32)
            x[1::3, ::4] = torch.randint(-2**31, 2**31 - 1, x[1::3, ::4].shape, generator=gen,
                                         device=dev, dtype=torch.int32)  # any int32 x
        if b < 256 or full:
            labels[::5] = -1  # out of range: contributes nothing, written nowhere
            labels[2::7] = c
        if wide:
            tab = tab.to(torch.int32)
        k_fn = lambda: ops.fit_bundle(x, tab, labels, c)  # noqa: E731
        p_fn = lambda: ref.fit_bundle(x, tab, labels, c)  # noqa: E731
        got = k_fn()
        torch.cuda.synchronize()
        path = ops.fit_table_path(tab.dtype, h, c)
        want_path = "histogram" if tab.dtype == torch.int8 and c <= 48 else "direct"
        if path != want_path:
            raise AssertionError(f"fit_bundle took the {path} path, not {want_path}")
        # the class-sum form's work: B*H histogram counts and C*H*D gather-adds
        n_bytes, n_ops = _RL.fit_bundle_work(b, h, d, c, tab.element_size())
        shape = dict(B=b, H=h, D=d, C=c, table=_dtype(tab),
                     **({"path": path} if path != "histogram" else {}),
                     **({"entries": "full_int8"} if full else {}))
        check("fit_bundle", [got], [p_fn()], shape,
              (k_fn, p_fn, n_bytes, n_ops) if b >= 256 and not full else None,
              direct_ops=2 * b * h * d + b * d)

    # -- encode_bundle_dynamic: the serving batch at each D-shard width, two
    #    row tiles (B = 65), B = 2048, a skip near 2**32, then ragged cases with
    #    8-bit thresholds (levels=256, the int32 compares) and uint16 entries -
    for b, h, d, skip, levels in [(64, 784, 8192, 1, 16), (64, 784, 2048, 1 + 2048, 16),
                                  (64, 784, 2040, 1 + 2040, 16), (65, 784, 8192, 1, 16),
                                  (2048, 784, 8192, 1, 16), (64, 784, 2048, 2**32 - 5, 16),
                                  (37, 100, 1000, 1000, 16), (33, 113, 257, 0, 256),
                                  (9, 40, 200, 3, 2**16)]:
        x, dirs = rand_x(b, h, levels), direction(h, levels)
        k_fn = lambda: ops.encode_bundle_dynamic(x, dirs, d, skip=skip)  # noqa: E731
        p_fn = lambda: ref.encode_bundle_dynamic(x, dirs, d, skip=skip)  # noqa: E731
        got = k_fn()
        torch.cuda.synchronize()
        n_bytes = b * h * 4 + h * 32 * dirs.element_size() + b * d * 4
        nb = int(np.bitwise_or.reduce(dirs.to(torch.int64).cpu().numpy().ravel())).bit_length()
        n_ops, n_popc = encode_dynamic_ops(b, h, d, nb)
        check("encode_bundle_dynamic", [got], [p_fn()],
              dict(B=b, H=h, D=d, skip=skip, levels=levels),
              (k_fn, p_fn, n_bytes, n_ops) if b == 64 and skip < 2**31 else None,
              direct_ops=2 * b * h * d, popc=n_popc, pr16_ops=n_ops + n_popc)

    # -- fit_bundle_dynamic: the fit batches and the D-shard batches on the
    #    histogram path; the smoke's batch on the direct path (the same
    #    direction entries as uint16); then ragged, with labels -1 and C, x
    #    outside [0, T), 8-bit thresholds, C = 26, skips near 2**32, and the
    #    direct path at C = 50 and with uint16 entries (levels = 1024) ------
    for b, h, d, c, skip, levels, wide in [
        (512, 784, 8192, 10, 1, 16, False), (4096, 784, 8192, 10, 1, 16, False),
        (256, 784, 2048, 10, 1 + 2048, 16, False), (256, 784, 2040, 10, 1 + 2040, 16, False),
        (512, 784, 8192, 10, 1, 16, True), (37, 100, 1000, 10, 1000, 16, False),
        (33, 113, 257, 26, 2**32 - 3, 256, False), (65, 30, 130, 10, 2**32 - 100, 16, False),
        (37, 100, 1000, 50, 1000, 16, False), (33, 113, 257, 10, 5, 1024, False),
    ]:
        x, dirs = rand_x(b, h, levels), direction(h, levels, "uint16" if wide else None)
        labels = torch.randint(0, c, (b,), generator=gen, device=dev, dtype=torch.int32)
        if b < 256:
            labels[::5] = -1  # out of range: contributes nothing, written nowhere
            labels[2::7] = c
            x[1::3, ::4] = torch.randint(-2**31, 2**31 - 1, x[1::3, ::4].shape, generator=gen,
                                         device=dev, dtype=torch.int32)  # any int32 x
        k_fn = lambda: ops.fit_bundle_dynamic(x, dirs, labels, c, d, skip=skip)  # noqa: E731
        p_fn = lambda: ref.fit_bundle_dynamic(x, dirs, labels, c, d, skip=skip)  # noqa: E731
        got = k_fn()
        torch.cuda.synchronize()
        path = ops.fit_dynamic_path(dirs.dtype, h, c)
        n_bytes = b * h * 4 + h * 32 * dirs.element_size() + b * 4 + c * d * 4
        # the histogram form's work: B*H counts, C*H*D gather-adds and H*D*nb
        # threshold popcounts, nb the bits this direction matrix uses
        nb = int(np.bitwise_or.reduce(dirs.to(torch.int64).cpu().numpy().ravel())).bit_length()
        check("fit_bundle_dynamic", [got], [p_fn()],
              dict(B=b, H=h, D=d, C=c, skip=skip, **({"path": path} if path != "histogram" else {})),
              (k_fn, p_fn, n_bytes, b * h + c * h * d) if b >= 256 else None,
              direct_ops=2 * b * h * d + b * d, popc=h * d * nb,
              pr16_ops=b * h + c * h * d + h * d * nb)
        want_path = "histogram" if dirs.dtype == torch.uint8 and c <= 48 else "direct"
        if path != want_path:
            raise AssertionError(f"fit_bundle_dynamic took the {path} path, not {want_path}")

    # -- hamming_topk: predict (k=1, the warp path), a 64 MiB store (k=8, the
    #    tensor path), crafted ties at C=33 (k=5, the warp path) and at k=C=1000
    #    (the tensor path, every row of a tile selected), the search cell's 1 GiB
    #    store (k=8; random words, a run of ties across a tile edge) ---------------
    for b, c, d, k in [(64, 10, 8192, 1), (64, 65536, 8192, 8), (64, 33, 8192, 5),
                       (16, 1000, 1000, 1000), (64, 2**20, 8192, 8)]:
        w = unary.n_words(d)
        if c == 2**20:  # packed words drawn directly: the bits would take 32 GiB
            q = torch.randint(-2**31, 2**31 - 1, (b, w), generator=gen, device=dev,
                              dtype=torch.int32)
            rows = torch.randint(-2**31, 2**31 - 1, (c, w), generator=gen, device=dev,
                                 dtype=torch.int32)
            rows[254:258] = q[0]
            rows[254:258, 0] ^= 1  # four rows at distance 1 from query 0, over a tile edge
        else:
            bits_q = torch.rand((b, d), generator=gen, device=dev) < 0.5
            bits_r = torch.rand((c, d), generator=gen, device=dev) < 0.5
            if d == 1000 or c == 33:
                bits_r[c // 2] = bits_r[1]  # duplicate rows: equal distances
                bits_r[c - 1] = bits_r[0]
                bits_r[3] = bits_q[0]  # an exact match
                bits_r[5:9] = bits_r[4]  # a run of ties
            q, rows = unary.pack_bits(bits_q), unary.pack_bits(bits_r)
        k_fn = lambda: ops.hamming_topk(q, rows, d, k)  # noqa: E731
        p_fn = lambda: ref.hamming_topk(q, rows, d, k)  # noqa: E731
        got = k_fn()
        torch.cuda.synchronize()
        want = ref.hamming_topk_oracle(q, rows, d, k) if c <= 1000 else p_fn()
        path = "warp" if c <= 64 else "tensor"
        if ops.topk_path(c) != path:
            raise AssertionError(f"hamming_topk took the {ops.topk_path(c)} path, not {path}")
        n_bytes = b * w * 4 + c * w * 4 + 2 * b * k * 4
        # the least work: the binary products on the tensor cores, 2*B*C*d operations
        # (d = 32 W); beside it the CUDA cores' count, an XOR, an add and a popcount a pair
        shape = dict(B=b, C=c, D=d, k=k)
        check("hamming_topk", list(got), list(want), shape,
              (k_fn, p_fn, n_bytes, 2 * b * c * 32 * w, BMMA_OPS_PER_S) if d == 8192 else None,
              popc_form=(2 * b * c * w, b * c * w))
        if c >= 65536:  # where the store search's time goes: its scan and merge launches
            t = results["hamming_topk"]["timed"][json.dumps(shape, sort_keys=True)]
            rows = t["device_rows"]
            merge = [r for r in rows if "merge_kernel" in r["name"]]
            whole = isinstance(t["device_ms"], float)
            emit("kernel_split", kernel="hamming_topk", shape=shape, path=path,
                 scan_ms=sum(r["ms"] for r in rows if "topk_kernel" in r["name"])
                 if whole else "not measured",
                 merge_ms=sum(r["ms"] for r in merge) if whole else "not measured",
                 merge_launches=sum(r["calls"] for r in merge), rows=rows)

    # -- hamming_packed: each store size (C = 1, 10, 64: the warp path; 65, 130,
    #    65,548: the tensor path) at a shard of each width (8192, 2048 and 2040
    #    bits: whole words and not) and at d = 33; a duplicate row and an exact
    #    match in each; the warp path's stores again with the tensor path forced
    #    (the path is a function of C alone, so a short call checks both) --------
    real_path = ops.packed_path
    for c in (1, 10, 64, 65, 130, 65548):
        for d in (8192, 2048, 2040, 33):
            b = 64 if d != 33 else 37
            w = unary.n_words(d)
            bits_q = torch.rand((b, d), generator=gen, device=dev) < 0.5
            bits_r = torch.rand((c, d), generator=gen, device=dev) < 0.5
            bits_r[c - 1] = bits_r[0]  # duplicate rows: equal scores
            bits_r[min(1, c - 1)] = bits_q[0]  # an exact match: score d
            q, rows = unary.pack_bits(bits_q), unary.pack_bits(bits_r)
            k_fn = lambda: ops.hamming_packed(q, rows, d)  # noqa: E731
            p_fn = lambda: ref.hamming_packed(q, rows, d)  # noqa: E731
            want = p_fn()
            path = "warp" if c <= 64 else "tensor"
            if ops.packed_path(c) != path:
                raise AssertionError(f"hamming_packed took the {ops.packed_path(c)} path, not {path}")
            for forced in ((None, "tensor") if path == "warp" else (None,)):
                ops.packed_path = (lambda *_: forced) if forced else real_path
                try:
                    got = k_fn()
                    torch.cuda.synchronize()
                finally:
                    ops.packed_path = real_path
                shape = dict(B=b, C=c, D=d, **({"path": forced} if forced else {}))
                timed = forced is None and b == 64 and (c == 10 or (c == 65548 and d != 2040))
                n_bytes = (b * w + c * w + b * c) * 4
                check("hamming_packed", [got], [want], shape,
                      (k_fn, p_fn, n_bytes, 2 * b * c * 32 * w, BMMA_OPS_PER_S)
                      if timed else None, popc_form=(2 * b * c * w, b * c * w))
                if timed and d != 2040:
                    library_packed_int_mm(torch, results, got, bits_q, bits_r, shape)

    # -- encode_unary_mxu: the uhd table encode's operands at the serving batch
    #    (also equal to encode_bundle's output), the baseline encoder's at the
    #    serving, evaluate and training batches, then ragged (B, D and K not a
    #    multiple of a tile) ---------------------------------------------------
    levels = 16
    p_base, l_base = (t.to(dev) for t in encoding.make_baseline_codebooks(
        prng.prng_key(0), 784, 8192, levels))
    for b, kind in [(64, "uhd"), (64, "baseline"), (1024, "baseline"), (2048, "baseline"),
                    (5, "ragged"), (65, "ragged"), (2000, "ragged")]:
        op_fn = None
        if kind == "uhd":
            x, tab = rand_x(b, 784, levels), table(784, 8192, levels)
            build = lambda: ref.unary_mxu_operands(x, tab, levels)  # noqa: E731
            op_fn = lambda: ops.encode_unary_mxu(x, tab, levels)  # noqa: E731
        elif kind == "baseline":
            x = rand_x(b, 784, levels)
            build = lambda: encoding.baseline_operands(x, p_base, l_base)  # noqa: E731
            op_fn = lambda: ops.encode_unary_mxu_operands(*build())  # noqa: E731
        else:
            # odd D (single stores), ragged B, D and K on the narrow and the wide tiles
            kk, d = {5: (1600, 701), 65: (1728, 8160), 2000: (13248, 8160)}[b]
            u0 = (torch.rand((b, kk), generator=gen, device=dev) < 0.3).to(torch.int8)
            o0 = (torch.rand((d, kk), generator=gen, device=dev) < 0.5).to(torch.int8)
            build = lambda: (u0, o0, 784)  # noqa: E731
        u, o, h = build()
        k_fn = lambda: ops.encode_unary_mxu_operands(u, o, h)  # noqa: E731
        p_fn = lambda: ref.encode_unary_mxu(u, o, h)  # noqa: E731
        got = k_fn()
        torch.cuda.synchronize()
        (bb, kk), d = u.shape, o.shape[0]
        shape = dict(B=bb, K=kk, D=d, operands=kind)
        want = [p_fn()]
        if kind == "uhd":
            if not torch.equal(got, ops.encode_bundle(x, tab)):
                raise AssertionError("encode_unary_mxu differs from encode_bundle on uhd operands")
        elif kind == "baseline" and b == 64:  # the gather form's (B, H, D) transient
            want.append(encoding.baseline_encode_naive(x, p_base, l_base))
        n_bytes = bb * kk + d * kk + bb * d * 4
        timed = None if kind == "ragged" else (k_fn, p_fn, n_bytes, 2 * bb * kk * d,
                                               INT8_TC_OPS_PER_S)
        check("encode_unary_mxu", [got] * len(want), want, shape, timed)
        if timed:
            t = results["encode_unary_mxu"]["timed"][json.dumps(shape, sort_keys=True)]
            if b in (64, 2048):
                library_unary_int_mm(torch, results, got, u, o, h, shape)
            op_ms = time_ms(torch, op_fn, 20)
            if kind == "uhd":
                times = dict(op_ms=op_ms, operand_build_ms=time_ms(torch, build, 20))
            else:
                # the whole op with O from the cache (as every call after a model's
                # first), with O built first (as a model's first call), and the two
                # operand builds alone
                def first():
                    encoding.BASELINE_OPERANDS.clear()
                    op_fn()

                times = dict(
                    op_ms=op_ms, op_first_build_ms=time_ms(torch, first, 5),
                    u_build_ms=time_ms(torch, lambda: ref.baseline_onehot_u(x, levels + 1), 20),
                    o_build_ms=time_ms(torch, lambda: ref.baseline_onehot_t(p_base, l_base), 5),
                    op_device_ms=device_ms(torch, op_fn, 10),
                )
            emit("op_time", kernel="encode_unary_mxu", shape=shape, kernel_ms=t["ms"],
                 kernel_device_ms=t["device_ms"], **times)
            t.update(times)
            if b == 2048:  # the tensor cores' heaviest load of the run
                t["sustained_ms"] = sustained(torch, k_fn, shape, 2500)["ms"]

    # -- bundle_binarize: train_hdc's batch, the smoke's, a D-shard's, then fewer
    #    rows than a cluster has blocks (B = 1, 7), two C tiles (C = 257) and
    #    ragged D (1000: element loads), each with out-of-range labels; both modes
    for b, c, d in [(2048, 10, 8192), (512, 10, 8192), (256, 10, 2048), (1, 10, 8192),
                    (7, 12, 1000), (300, 257, 2048), (64, 257, 1000)]:
        hv = torch.randint(-784, 785, (b, d), generator=gen, device=dev, dtype=torch.int32)
        labels = torch.randint(0, c, (b,), generator=gen, device=dev, dtype=torch.int32)
        if b == 7 or c == 257:
            labels[2] = c  # out of range: dropped
            labels[::5] = -1
        for binarize in (False, True):
            k_fn = lambda: ops.bundle_binarize(hv, labels, c, binarize=binarize)  # noqa: E731
            p_fn = lambda: ref.bundle_binarize(  # noqa: E731
                hv, ref.class_onehot(labels, c), binarize=binarize)
            got = k_fn()
            torch.cuda.synchronize()
            shape = dict(B=b, C=c, D=d, binarize=binarize)
            n_bytes = b * d * 4 + b * 4 + c * d * (1 if binarize else 4)
            timed = (k_fn, p_fn, n_bytes, b * d) if b >= 256 and c == 10 else None
            check("bundle_binarize", [got], [p_fn()], shape, timed)
            if b == 2048 and parse_key(launch_key(torch, ops, "bundle_binarize", k_fn))["cluster"] < 2:
                raise AssertionError("bundle_binarize did not split B over a cluster at B = 2048")
            if timed and not binarize:
                library_index_add(torch, results, got, hv, labels, c, shape)
    return results


def sustained(torch, fn, shape, calls: int) -> dict:
    """`calls` back-to-back calls of fn (about a second), timed by CUDA events,
    with ``nvidia-smi`` sampling the SM clock and the power draw every 50 ms
    beside them: a launch's time under sustained load, where the card may lower
    its clock to stay inside its power limit."""
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    time.sleep(0.3)  # a few samples before the load
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    time.sleep(0.1)
    smi.terminate()
    out, _ = smi.communicate(timeout=30)
    samples = []
    for line in out.splitlines():
        try:
            samples.append([float(v) for v in line.split(",")])
        except ValueError:
            continue
    result = dict(shape=shape, calls=calls, ms=start.elapsed_time(end) / calls, load_s=load_s,
                  samples=samples)
    emit("sustained", **result)
    return result


def library_unary_int_mm(torch, results, got, u, o, h, shape) -> None:
    """Time ``torch._int_mm`` of kernel 7's own int8 operands, (B, K) times
    the (K, D) transpose of O (made contiguous outside the timed region);
    2 * count - h must equal the kernel's output."""
    ot = o.t().contiguous()
    counts = torch._int_mm(u, ot)
    torch.cuda.synchronize()
    equal = torch.equal(2 * counts - h, got)
    ms = time_ms(torch, lambda: torch._int_mm(u, ot), 20)
    emit("library_time", kernel="encode_unary_mxu", call="torch._int_mm", shape=shape, ms=ms,
         equal=equal)
    if not equal:
        raise AssertionError("torch._int_mm's counts differ from encode_unary_mxu's")
    results["encode_unary_mxu"]["timed"][json.dumps(shape, sort_keys=True)]["library_ms"] = ms


def library_index_add(torch, results, got, hv, labels, c, shape) -> None:
    """Time one int32 ``index_add_`` computing the class sums (all labels are
    in range here); the result must equal the kernel's."""
    lab = labels.to(torch.int64)
    zeros = torch.zeros((c, hv.shape[1]), dtype=torch.int32, device=hv.device)
    fn = lambda: zeros.clone().index_add_(0, lab, hv)  # noqa: E731
    equal = torch.equal(fn(), got)
    ms = time_ms(torch, fn, 50)
    emit("library_time", kernel="bundle_binarize", call="Tensor.index_add_", shape=shape,
         ms=ms, equal=equal)
    if not equal:
        raise AssertionError("index_add_'s sums differ from bundle_binarize's")
    results["bundle_binarize"]["timed"][json.dumps(shape, sort_keys=True)]["library_ms"] = ms


def path_launches(ops, name: str, kernels: tuple[str, ...], fn, absent: tuple[str, ...] = ()):
    """Run fn with every launch count set to 0 before and read after; raise
    if it launched none of `kernels`, the kernels of that path, or any of
    `absent`, kernels that are not on it."""
    import torch

    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    PATH_SHAPES[name] = {k: dict(v) for k, v in ops.LAUNCH_SHAPES.items()}
    emit("launches", path=name, launches=launches, by_card=launches_by_card(ops))
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the {name} path launched no {missing} kernel")
    stray = [k for k in absent if launches[k]]
    if stray:
        raise AssertionError(f"the {name} path launched {stray}, which are not on it")
    return out, launches


def launches_by_card(ops) -> dict[str, dict[str, int]]:
    """The launches counted since the last reset, by kernel and card index."""
    return {k: {str(c): n for c, n in sorted(v.items())} for k, v in ops.LAUNCH_CARDS.items() if v}


def uncounted(ops, fn):
    """fn's result, with the launch counts left as they were before it."""
    launches = dict(ops.LAUNCHES)
    kept = [(counts, {k: dict(v) for k, v in counts.items()})
            for counts in (ops.LAUNCH_SHAPES, ops.LAUNCH_CARDS)]
    out = fn()
    ops.LAUNCHES.update(launches)
    for counts, before in kept:
        for k, v in before.items():
            counts[k].clear()
            counts[k].update(v)
    return out


def sha256_of(sums) -> str:
    return hashlib.sha256(sums.cpu().numpy().astype("<i4").tobytes()).hexdigest()


def slice_phase(torch, ops, serve_hdc, load_dataset, encoder: str, kernels: tuple[str, ...],
                absent: tuple[str, ...] = ()):
    """The serving smoke at the JAX smoke's configuration, launches counted:
    ``serve_hdc.smoke`` registers step 0 behind the ``MicroBatcher`` and
    serves 128 requests one at a time, trains step 1 and hot-reloads to it
    with the other 128 queued.  Emits the ``slice`` checks (class sums,
    accuracy, search) and the ``serve_plane`` line (the batcher's latency,
    throughput, occupancy and counters, the graph replays, and the served
    labels against each step's eager step)."""
    import numpy as np

    ckpt = ROOT / "build" / f"chip_smoke_ckpt_{encoder}"
    args = serve_hdc.parser().parse_args([
        "--smoke", "--dataset", "synth_mnist", "--encoder", encoder, "--d", "8192",
        "--levels", "16", "--n-train", "1024", "--requests", "256", "--batch", "64",
        "--device", "cuda", "--ckpt", str(ckpt),
    ])

    def run():
        result = serve_hdc.smoke(args)
        converted = None
        if encoder == "uhd":  # the table-trained model served table-free
            model = result.models[1]
            converted = model.convert("uhd_dynamic")
            if not torch.equal(converted.predict(result.probe), model.predict(result.probe)):
                raise AssertionError("the uhd model converted to uhd_dynamic predicts otherwise")
        return result, converted

    (result, converted), launches = path_launches(ops, f"slice_{encoder}", kernels, run, absent)
    want_sha, want_acc = ((JAX_BASELINE_SHA256, JAX_BASELINE_SERVED_ACCURACY)
                          if encoder == "baseline" else (JAX_CLASS_SUMS_SHA256, JAX_SERVED_ACCURACY))

    for step, (model, want) in enumerate(zip(result.models, want_sha)):
        got = sha256_of(model.class_sums)
        emit("class_sums", encoder=encoder, step=step, sha256=got, jax_sha256=want,
             equal=got == want)
        if got != want:
            raise AssertionError(f"{encoder} step {step} class sums differ from the JAX package's")

    engine = result.engines[1]
    idx, dist = engine.search(result.probe, 3)
    labels = engine.predict(result.probe)
    if not (idx[:, 0] == labels).all():
        raise AssertionError("search(k=3)[:, 0] differs from predict")
    if not ((dist[:, :-1] <= dist[:, 1:]).all() and (dist >= 0).all()):
        raise AssertionError("search distances are not ascending")
    if round(result.accuracy, 4) != round(want_acc, 4):
        raise AssertionError(f"{encoder} served accuracy {result.accuracy} != JAX's {want_acc}")
    emit("slice", encoder=encoder, accuracy=result.accuracy, jax_accuracy=want_acc,
         n_requests=len(result.labels), batch=args.batch, fit_s=result.fit_s[0],
         partial_fit_s=result.fit_s[1], packed_parity=True, search_top1_equals_predict=True,
         converted_to_uhd_dynamic_predicts_equal=True if converted is not None else None)

    # the batcher's labels against each step's eager step, request by request
    stream = load_dataset("synth_mnist", n_train=1024, n_test=256).test_images
    half = len(stream) // 2
    eager_equal = []
    for step, (e, sl) in enumerate(zip(result.engines, (slice(0, half), slice(half, None)))):
        eager = uncounted(ops, lambda e=e, sl=sl: e.execution.predict(
            e.model, e.class_words, stream[sl]).cpu().numpy())
        eager_equal.append(bool((result.labels[sl] == eager).all()))
    steps_ok = result.steps.tolist() == [0] * half + [1] * (len(stream) - half)
    snap = result.metrics
    lat = [s.latency_s for s in result.served]
    serve_s = sum(s.wall_s for s in result.served)
    emit(
        "serve_plane", encoder=encoder, n_requests=snap["n_requests"], batch=args.batch,
        p50_ms=snap["p50_ms"], p99_ms=snap["p99_ms"], mean_ms=snap["mean_ms"],
        p50_ms_before_reload=float(np.percentile(lat[0], 50) * 1e3),
        p99_ms_before_reload=float(np.percentile(lat[0], 99) * 1e3),
        p50_ms_queued_at_reload=float(np.percentile(lat[1], 50) * 1e3),
        img_per_s=len(result.labels) / serve_s, serve_s=serve_s,
        batch_occupancy=snap["batch_occupancy"], n_batches=snap["n_batches"],
        n_reloads=snap["n_reloads"], n_errors=snap["n_errors"],
        queued_at_reload=result.queued_at_reload,
        graph_replays=[e.n_replays for e in result.engines],
        graphs=[e.describe()["graphs"] for e in result.engines],
        device_stage_ms=snap["stages"]["device"]["p50_ms"],
        queue_stage_ms=snap["stages"]["queue"]["p50_ms"],
        steps_by_request_ok=steps_ok, labels_equal_eager=eager_equal,
    )
    if not (snap["n_errors"] == 0 and snap["n_reloads"] == 1 and snap["n_requests"] == 256
            and result.queued_at_reload == half and steps_ok and all(eager_equal)
            and all(e.n_replays > 0 for e in result.engines)):
        raise AssertionError(f"the {encoder} serving plane failed its checks")
    return launches, result


def train_phase(torch, ops, train_hdc, load_dataset):
    """``train_hdc`` at its defaults, launches counted, held against JAX."""
    args = train_hdc.parser().parse_args(
        ["--device", "cuda", "--save-dir", str(ROOT / "build" / "chip_smoke_train")]
    )
    result, launches = path_launches(
        ops, "train_hdc", ("fit_bundle", "encode_bundle"), lambda: train_hdc.train(args)
    )
    got = sha256_of(result.model.class_sums)
    ds = load_dataset(args.dataset, n_train=args.n_train, n_test=args.n_test)
    labels = result.model.predict(ds.test_images).cpu().numpy()
    want = [int(c) for c in "".join(JAX_TRAIN_LABELS)]
    n_differ = int(sum(int(a) != b for a, b in zip(labels, want)))
    emit("train", encoder=args.encoder, d=args.d, n_train=args.n_train, batch=args.batch_size,
         class_sums_sha256=got, jax_sha256=JAX_TRAIN_SHA256, equal=got == JAX_TRAIN_SHA256,
         accuracy=result.accuracy, jax_accuracy=JAX_TRAIN_ACCURACY,
         labels_differing_from_jax=n_differ, fit_s=result.fit_s, evaluate_s=result.eval_s,
         round_trip_ok=result.round_trip_ok)
    if got != JAX_TRAIN_SHA256:
        raise AssertionError("train_hdc class sums differ from the JAX package's")
    if abs(result.accuracy - JAX_TRAIN_ACCURACY) > 2 / 1024 or n_differ > 2:
        raise AssertionError(f"train_hdc labels differ from JAX's on {n_differ} images")
    if result.round_trip_ok is not True:
        raise AssertionError("train_hdc checkpoint round trip failed")
    return launches


def train_baseline_phase(torch, ops, train_hdc, load_dataset):
    """``train_hdc --encoder baseline --compare-baseline --baseline-iters 5`` at
    the launcher's defaults, launches counted: the seed-0 model and each
    retrain's class sums against the JAX package's checksums, their cosine
    labels against JAX's (at most 2 of 1024 may differ, the float32 near-tie
    rule), and the checkpoint round trip."""
    import numpy as np

    from repro_torch.core import encoding

    args = train_hdc.parser().parse_args([
        "--device", "cuda", "--encoder", "baseline", "--compare-baseline",
        "--baseline-iters", "5", "--save-dir", str(ROOT / "build" / "chip_smoke_train_baseline"),
    ])
    ds = load_dataset(args.dataset, n_train=args.n_train, n_test=args.n_test)
    runs = []

    def check(what, seed, model):
        """A model's checksum and labels against JAX's, taken on the spot (the
        launcher keeps no retrained model); the predict is not the path's, so
        its launches are not counted."""
        got = sha256_of(model.class_sums)
        labels = uncounted(ops, lambda: model.predict(ds.test_images).cpu().numpy())
        want = [int(c) for c in "".join(JAX_BASELINE_TRAIN_LABELS[seed])]
        runs.append(dict(run=what, seed=seed, class_sums_sha256=got, labels=labels,
                         labels_differing_from_jax=int(sum(int(a) != b
                                                           for a, b in zip(labels, want)))))

    builds0 = encoding.BASELINE_OPERANDS.builds
    result, launches = path_launches(
        ops, "train_baseline", ("encode_unary_mxu", "bundle_binarize"),
        lambda: train_hdc.train(args, on_retrain=lambda i, m: check("retrain", i, m)),
        ("encode_bundle", "fit_bundle", "encode_bundle_dynamic", "fit_bundle_dynamic"),
    )
    # [P == L] is built once per model: the seed-0 model and the five retrains
    builds = encoding.BASELINE_OPERANDS.builds - builds0
    emit("operand_cache", path="train_baseline", models=6, builds=builds)
    if builds != 6:
        raise AssertionError(f"train_baseline built [P == L] {builds} times for 6 models")
    check("train", 0, result.model)
    runs.insert(0, runs.pop())
    accs = [result.accuracy] + list(result.baseline_accs)
    for r, acc in zip(runs, accs):
        seed = r["seed"]
        got = r["class_sums_sha256"]
        n_differ = r["labels_differing_from_jax"]
        jax_acc = JAX_BASELINE_TRAIN_ACCURACY[seed]
        emit("train_baseline", run=r["run"], seed=seed, class_sums_sha256=got,
             jax_sha256=JAX_BASELINE_TRAIN_SHA256[seed], equal=got == JAX_BASELINE_TRAIN_SHA256[seed],
             accuracy=acc, jax_accuracy=jax_acc, labels_differing_from_jax=n_differ)
        if got != JAX_BASELINE_TRAIN_SHA256[seed]:
            raise AssertionError(f"baseline seed {seed} class sums differ from the JAX package's")
        if abs(acc - jax_acc) > 2 / 1024 or n_differ > 2:
            raise AssertionError(f"baseline seed {seed} labels differ from JAX's on {n_differ} images")
    if len(runs) != 6:
        raise AssertionError(f"train_baseline saw {len(runs) - 1} retrains, not 5")
    if len(result.baseline_accs) != 5 or result.round_trip_ok is not True:
        raise AssertionError("train_hdc --encoder baseline: retrains missing or round trip failed")
    accs = np.asarray(result.baseline_accs)
    jax_accs = np.asarray(JAX_BASELINE_TRAIN_ACCURACY)
    emit("train_baseline", run="summary", avg=float(accs.mean()), best=float(accs.max()),
         jax_avg=float(jax_accs.mean()), jax_best=float(jax_accs.max()), fit_s=result.fit_s,
         evaluate_s=result.eval_s, round_trip_ok=result.round_trip_ok)
    return launches


def item_memory_phase(torch, ops, ref, ItemMemory):
    """65,536 random rows at d=8192 (64 MiB of words), a delete, more adds,
    then search(k=8) against the plain version and each stored query first."""
    import numpy as np

    d, n, k = 8192, 65536, 8
    rng = np.random.default_rng(0)
    mem = ItemMemory(d, device="cuda")
    first = rng.integers(0, 2**32, (n, mem.n_words), dtype=np.uint32)
    more = rng.integers(0, 2**32, (16, mem.n_words), dtype=np.uint32)
    gone = [0, 7, 40_000, n - 1]
    mem.add_packed(first)
    mem.delete(gone)
    mem.add_packed(more)
    stored = np.concatenate([np.delete(first, gone, axis=0), more])  # what the store holds
    pos = np.concatenate([np.arange(48) * 1361, np.arange(len(stored) - 16, len(stored))])
    (idx, dist), launches = path_launches(
        ops, "item_memory", ("hamming_topk",), lambda: mem.search(stored[pos], k)
    )
    rows = torch.from_numpy(stored.view(np.int32)).cuda()
    want_i, want_d = ref.hamming_topk(rows[torch.from_numpy(pos).cuda()], rows, d, k)
    equal = bool((idx == want_i.cpu().numpy()).all() and (dist == want_d.cpu().numpy()).all())
    first_hit = bool((idx[:, 0] == pos).all() and (dist[:, 0] == 0).all())
    emit("item_memory", rows=len(mem), mib=mem.nbytes / 2**20, queries=len(pos), k=k,
         equal_plain=equal, stored_query_first_at_0=first_hit)
    if len(mem) != len(stored) or not (equal and first_hit):
        raise AssertionError("ItemMemory.search disagrees with the plain version")
    return launches, stored


def serve_batches(engine, images, batch: int):
    """Serve `images` through ``engine.predict`` in static batches of `batch`
    rows (the last padded), each timed on the host clock; the predict
    returns host labels, so its time covers the device's work.  Returns
    (labels, seconds of each batch)."""
    import numpy as np

    labels, times = [], []
    for i in range(0, len(images), batch):
        chunk = images[i : i + batch]
        padded = np.zeros((batch,) + chunk.shape[1:], chunk.dtype)
        padded[: len(chunk)] = chunk
        t0 = time.perf_counter()
        out = engine.predict(padded)
        times.append(time.perf_counter() - t0)
        labels.append(out[: len(chunk)])
    return np.concatenate(labels).astype(np.int32), times


def sharded_phase(torch, ops, api, encoder: str, d: int, dev):
    """D-sharded training and serving at the smoke's configuration (the
    baseline encoder's shards run kernels 7 and 8 at D / 4 columns).

    ``partial_fit_sharded`` of 512 + 512 images on the card's own
    ``(data, model)`` mesh (``mesh_for()``) and on a (data 2, model 4) mesh
    of one device, each step's class sums held against the JAX package's
    checksums (D = 8192) or the single-device ``partial_fit`` (other D);
    the (2, 4) steps checkpointed as 4 per-host shards; then the smoke's
    stream (128 requests on step 0, 128 on step 1, batches of 64) served
    through ``ShardedExecution`` on 1 and 4 shards, loaded from those
    shards, with labels, accuracy and ``search(k=3)`` held against the
    ``DeviceExecution`` engines.  Returns the launches by path and the
    4-shard step-1 engine."""
    import numpy as np

    ds = api.load_dataset("synth_mnist", n_train=1024, n_test=256)
    cfg = api.HDCConfig(n_features=ds.n_features, n_classes=ds.n_classes, d=d, levels=16,
                        encoder=encoder)
    steps = [(ds.train_images[:512], ds.train_labels[:512]),
             (ds.train_images[512:], ds.train_labels[512:])]
    fit_kernels, enc_kernel = {
        "uhd_dynamic": (("fit_bundle_dynamic",), "encode_bundle_dynamic"),
        "uhd": (("fit_bundle",), "encode_bundle"),
        "baseline": (("encode_unary_mxu", "bundle_binarize"), "encode_unary_mxu"),
    }[encoder]
    jax_sha, jax_acc = ((JAX_BASELINE_SHA256, JAX_BASELINE_SERVED_ACCURACY)
                        if encoder == "baseline" else (JAX_CLASS_SUMS_SHA256, JAX_SERVED_ACCURACY))
    if d == 8192:
        want = list(jax_sha)
    else:
        single = [api.HDCModel.create(cfg, device=dev)]
        for x, y in steps:
            single.append(single[-1].partial_fit(x, y))
        want = [sha256_of(m.class_sums) for m in single[1:]]
    by_path = {}
    meshes = {"card": api.mesh_for(devices=None if dev.type == "cuda" else [dev]),
              "2x4": api.mesh_for(8, 4, devices=[dev] * 8)}
    for name, mesh in meshes.items():
        def train(mesh=mesh):
            models = [api.HDCModel.create(cfg, device=dev)]
            t0 = time.perf_counter()
            for x, y in steps:
                models.append(api.partial_fit_sharded(models[-1], x, y, mesh=mesh))
            sync_all(torch, mesh.devices.flat)
            return models[1:], time.perf_counter() - t0

        path = f"sharded_fit_{encoder}_d{d}_{name}"
        (models, fit_s), by_path[path] = path_launches(ops, path, fit_kernels, train)
        got = [sha256_of(m.class_sums) for m in models]
        emit("sharded_fit", encoder=encoder, d=d, mesh=mesh.shape, shards=models[0].n_shards,
             sha256=got, want_sha256=want, against="jax" if d == 8192 else "partial_fit",
             equal=got == want, fit_s=fit_s)
        if got != want:
            raise AssertionError(f"sharded class sums ({encoder}, D={d}, {name}) differ")

    ckpt = ROOT / "build" / f"chip_smoke_sharded_{encoder}_d{d}"
    for step, model in enumerate(models):
        for pi in range(4):
            model.save_shard(ckpt, step=step, process_index=pi, process_count=4)
        api.CheckpointManager(ckpt).finalize_shards(step)

    probe = ds.test_images[:64]

    def serve(execution):
        engines = [api.ServingEngine.from_checkpoint(ckpt, step=s, batch_size=64,
                                                     execution=execution) for s in (0, 1)]
        stats = [serve_batches(engines[0], ds.test_images[:128], 64),
                 serve_batches(engines[1], ds.test_images[128:], 64)]
        labels = np.concatenate([st[0] for st in stats])
        return engines[1], labels, engines[1].search(probe, 3), stats[0][1] + stats[1][1]

    _, want_labels, (want_i, want_d), single_s = serve(api.DeviceExecution(device=dev))
    engine = None
    for n in ((1, 4) if d == 8192 else (4,)):
        execution = api.ShardedExecution(devices=[dev] * n)
        path = f"sharded_serve_{encoder}_d{d}_x{n}"
        (engine, labels, (idx, dist), batch_s), by_path[path] = path_launches(
            ops, path, (enc_kernel, "hamming_packed"), lambda: serve(execution)
        )
        acc = float((labels == ds.test_labels).mean())
        same = bool((labels == want_labels).all())
        same_search = bool((idx == want_i).all() and (dist == want_d).all())
        emit("sharded_serve", encoder=encoder, d=d, shards=n, d_local=d // n,
             accuracy=acc, labels_equal_device=same, search_equal_device=same_search,
             batch_ms_mean=1e3 * sum(batch_s) / len(batch_s),
             device_batch_ms_mean=1e3 * sum(single_s) / len(single_s),
             describe=engine.describe()["execution"])
        if not (same and same_search):
            raise AssertionError(f"sharded serving ({encoder}, D={d}, {n} shards) differs "
                                 "from the single-device engine")
        if d == 8192 and round(acc, 4) != round(jax_acc, 4):
            raise AssertionError(f"sharded served accuracy {acc} != JAX's {jax_acc}")
    return by_path, engine


def sharded_search_phase(torch, ops, api, model, images, stored, dev):
    """The ItemMemory phase's 65,548 stored rows searched (k=8) through
    ``ShardedExecution`` on 1 and 4 shards with queries encoded by `model`,
    held against the single-device search (kernel 5)."""
    import numpy as np

    rows = torch.from_numpy(np.ascontiguousarray(stored).view(np.int32)).to(dev)
    want_i, want_d = api.DeviceExecution(device=dev).search(model, rows, images, 8)
    by_path = {}
    for n in (1, 4):
        execution = api.ShardedExecution(devices=[dev] * n)
        words = execution.shard_words(rows, model.cfg.d)
        placed = execution.place(model)

        def search(execution=execution, words=words, placed=placed):
            t0 = time.perf_counter()
            out = execution.search(placed, words, images, 8)
            sync_all(torch, execution.mesh.devices.flat)
            return out, time.perf_counter() - t0

        path = f"sharded_search_x{n}"
        ((idx, dist), wall_s), by_path[path] = path_launches(
            ops, path, ("encode_bundle", "hamming_packed"), search
        )
        equal = bool(torch.equal(idx, want_i) and torch.equal(dist, want_d))
        emit("sharded_search", rows=rows.shape[0], d=model.cfg.d, shards=n, queries=len(images),
             k=8, equal_device_search=equal, wall_ms=wall_s * 1e3)
        if not equal:
            raise AssertionError(f"sharded search on {n} shards differs from kernel 5's")
    return by_path


def sharded_cards_phase(torch, ops, api, result, stored, cards: list):
    """The HDC paths on distinct cards, `cards` (cuda:0 .. cuda:N-1, N =
    min(visible cards, 4)), held exactly against the one-card paths and JAX.

    For each encoder at D = 8192, ``partial_fit_sharded`` of the smoke's 512 +
    512 images on ``mesh_for()`` over the N cards (and, at N = 4, on a (data 2,
    model 2) mesh of them), the class sums against the JAX package's checksums
    and ``fit_s`` with every card of the mesh synchronised; those steps served
    through a ``ServingEngine`` over ``ShardedExecution(devices=cards)``, and
    the same steps loaded from the 4 per-host shards that ``sharded_phase``
    wrote, each engine's labels (the smoke's stream) and ``search(k=3)``
    against the one-card ``DeviceExecution`` engine's and the accuracy
    against JAX's; the item-memory store (65,548 rows) searched (k = 8)
    across the N cards against kernel 5's search on one card; a
    ``ReplicaPool`` of N single-card replicas (``DeviceExecution(device=
    cuda:i)``, each capturing its graph on its own card) under a hot reload
    (:func:`pool_checks`).  At N = 1 the same code runs on the one card, and
    the line says that its cross-card checks were one-card checks.  Returns
    the launches and the N-card step-1 engine of each encoder."""
    import numpy as np

    n = len(cards)
    names = [str(c) for c in cards]
    ds = api.load_dataset("synth_mnist", n_train=1024, n_test=256)
    steps = [(ds.train_images[:512], ds.train_labels[:512]),
             (ds.train_images[512:], ds.train_labels[512:])]
    meshes = {"cards": api.mesh_for(devices=cards)}
    if n == 4:
        meshes["2x2"] = api.mesh_for(4, 2, devices=cards)
    probe = ds.test_images[:64]
    checks, fits, serves, engines = {}, [], [], {}

    def one_card(engine):
        """The labels of the smoke's stream and search(k=3) of the probe."""
        labels, _ = serve_batches(engine, ds.test_images, 64)
        return labels, engine.search(probe, 3)

    def run():
        for encoder in ("uhd_dynamic", "uhd", "baseline"):
            cfg = api.HDCConfig(n_features=ds.n_features, n_classes=ds.n_classes, d=8192,
                                levels=16, encoder=encoder)
            jax_sha, jax_acc = ((JAX_BASELINE_SHA256, JAX_BASELINE_SERVED_ACCURACY)
                                if encoder == "baseline"
                                else (JAX_CLASS_SUMS_SHA256, JAX_SERVED_ACCURACY))
            fitted = {}
            for name, mesh in meshes.items():
                models = [api.HDCModel.create(cfg, device=cards[0])]
                t0 = time.perf_counter()
                for x, y in steps:
                    models.append(api.partial_fit_sharded(models[-1], x, y, mesh=mesh))
                sync_all(torch, mesh.devices.flat)
                fit_s = time.perf_counter() - t0
                got = [sha256_of(m.class_sums) for m in models[1:]]
                checks[f"fit_{encoder}_{name}"] = got == list(jax_sha)
                fits.append(dict(encoder=encoder, mesh=mesh.shape, shards=models[1].n_shards,
                                 fit_s=fit_s, sha256_equal_jax=got == list(jax_sha)))
                fitted[name] = models[1:]
            ckpt = ROOT / "build" / f"chip_smoke_sharded_{encoder}_d8192"
            want = uncounted(ops, lambda: [
                one_card(api.ServingEngine.from_checkpoint(
                    ckpt, step=s, batch_size=64, execution=api.DeviceExecution(device=cards[0])))
                for s in (0, 1)])
            forms = {f"fit_{name}": [
                api.ServingEngine(m, batch_size=64, step=s,
                                  execution=api.ShardedExecution(devices=cards))
                for s, m in enumerate(models)] for name, models in fitted.items()}
            forms["host_shards"] = [api.ServingEngine.from_checkpoint(
                ckpt, step=s, batch_size=64, execution=api.ShardedExecution(devices=cards))
                for s in (0, 1)]
            for form, pair in forms.items():
                got = [one_card(e) for e in pair]
                half = len(ds.test_images) // 2  # step 0 serves the first half
                labels = np.concatenate([got[0][0][:half], got[1][0][half:]])
                acc = float((labels == ds.test_labels).mean())
                same = all((g[0] == w[0]).all() and (g[1][0] == w[1][0]).all()
                           and (g[1][1] == w[1][1]).all() for g, w in zip(got, want))
                ok = same and round(acc, 4) == round(jax_acc, 4) and all(
                    execution_cards(e.describe()["execution"]) == names
                    and [st.device for st in e.streams] == [c for c in cards if c.type == "cuda"]
                    for e in pair)
                checks[f"serve_{encoder}_{form}"] = ok
                serves.append(dict(encoder=encoder, form=form, accuracy=acc,
                                   labels_and_search_equal_one_card=same,
                                   execution=pair[1].describe()["execution"],
                                   graph=pair[1].describe()["graph"],
                                   streams=[str(st.device) for st in pair[1].streams]))
            engines[encoder] = forms["host_shards"][1]

        model, images = result.models[1], result.probe
        rows = torch.from_numpy(np.ascontiguousarray(stored).view(np.int32)).to(cards[0])
        want_i, want_d = uncounted(
            ops, lambda: api.DeviceExecution(device=cards[0]).search(model, rows, images, 8))
        ex = api.ShardedExecution(devices=cards)
        words, placed = ex.shard_words(rows, model.cfg.d), ex.place(model)
        t0 = time.perf_counter()
        idx, dist = ex.search(placed, words, images, 8)
        sync_all(torch, cards)
        search = dict(rows=rows.shape[0], k=8, wall_ms=1e3 * (time.perf_counter() - t0),
                      words_on=sorted({str(w.device) for w in words}),
                      equal_one_card=bool(torch.equal(idx, want_i) and torch.equal(dist, want_d)))
        checks["search"] = search["equal_one_card"]

        blocks = [ds.test_images[i : i + 8] for i in range(0, 256, 8)]
        executions = [api.DeviceExecution(device=c) for c in cards]
        pool, step, reload_s, out = pool_under_reload(
            api, result.engines[0].source, executions, blocks)
        pool_line = pool_checks(ops, pool, step, out, result, ds.test_images)
        replicas = [r.engine.describe() for r in pool.replicas]
        pool_line.update(reload_s=reload_s, replicas=[d["execution"] for d in replicas],
                         graphs=[len(d["graphs"]) for d in replicas])
        checks["pool"] = pool_line["ok"] and all(
            d["graph"] and d["graphs"] and d["execution"]["device"] == c
            for d, c in zip(replicas, names))
        return search, pool_line

    t0 = time.perf_counter()
    (search, pool_line), launches = path_launches(ops, "sharded_cards", tuple(KERNELS), run)
    emit("sharded_cards", cards=n, devices=names, cross_card=n > 1,
         note=None if n > 1 else "one card visible: every cross-card check ran on that card",
         seconds=time.perf_counter() - t0, checks=checks, fits=fits, serves=serves,
         search=search, pool=pool_line, launches_by_card=launches_by_card(ops))
    if not all(checks.values()):
        failed = [k for k, v in checks.items() if not v]
        raise AssertionError(f"the sharded_cards phase failed {failed}")
    return launches, engines


def policy_phase(torch, ops, api, model, dev):
    """The serving smoke's step-1 baseline model under non-default scoring
    policies (JAX_POLICY), checkpointed and served through a ``ServingEngine``
    (256 requests in batches of 64), launches counted; the served labels and
    ``HDCModel.predict``'s (hamming) against the JAX package's."""
    import dataclasses

    import numpy as np

    ds = api.load_dataset("synth_mnist", n_train=1024, n_test=256)
    policy_model = api.HDCModel(dataclasses.replace(model.cfg, **JAX_POLICY), model.codebooks,
                                model.class_sums, model.n_seen, device=dev)
    ckpt = ROOT / "build" / "chip_smoke_policy"
    policy_model.save(ckpt, step=0)

    def serve():
        engine = api.ServingEngine.from_checkpoint(ckpt, step=0, batch_size=64, device=dev)
        return serve_batches(engine, ds.test_images, 64)

    (served, batch_s), launches = path_launches(
        ops, "slice_policy", ("encode_unary_mxu", "hamming_topk"), serve)
    want = np.asarray([int(c) for c in JAX_POLICY_LABELS])
    direct = policy_model.predict(ds.test_images).cpu().numpy()
    served_equal, direct_equal = bool((served == want).all()), bool((direct == want).all())
    acc = float((served == ds.test_labels).mean())
    emit("slice_policy", encoder=model.cfg.encoder, policy=JAX_POLICY, accuracy=acc,
         jax_accuracy=JAX_POLICY_ACCURACY, served_labels_equal_jax=served_equal,
         predict_labels_equal_jax=direct_equal,
         batch_ms_mean=1e3 * sum(batch_s) / len(batch_s))
    if not (served_equal and direct_equal and acc == JAX_POLICY_ACCURACY):
        raise AssertionError("the non-default policy's labels differ from the JAX package's")
    return launches


def train_shard_map_phase(torch, ops, train_hdc):
    """``train_hdc --shard-map --ckpt-shards 4`` at the launcher's defaults."""
    args = train_hdc.parser().parse_args([
        "--device", "cuda", "--shard-map", "--ckpt-shards", "4",
        "--save-dir", str(ROOT / "build" / "chip_smoke_train_sharded"),
    ])
    result, launches = path_launches(
        ops, "train_shard_map", ("fit_bundle", "encode_bundle"), lambda: train_hdc.train(args)
    )
    got = sha256_of(result.model.class_sums)
    emit("train_shard_map", encoder=args.encoder, d=args.d, n_train=args.n_train,
         shards=result.model.n_shards, mesh=result.model.mesh.shape, class_sums_sha256=got,
         jax_sha256=JAX_TRAIN_SHA256, equal=got == JAX_TRAIN_SHA256, accuracy=result.accuracy,
         fit_s=result.fit_s, evaluate_s=result.eval_s, round_trip_ok=result.round_trip_ok)
    if got != JAX_TRAIN_SHA256:
        raise AssertionError("train_hdc --shard-map class sums differ from the JAX package's")
    if result.round_trip_ok is not True:
        raise AssertionError("train_hdc --ckpt-shards 4 round trip failed")
    return launches


def parse_key(key: str) -> dict:
    """``"B=64 H=784 table=int8"`` -> {"B": 64, "H": 784, "table": "int8"}."""
    out = {}
    for part in key.split():
        k, v = part.split("=", 1)
        out[k] = int(v) if v.lstrip("-").isdigit() else v
    return out


def by_rows(plain, b: int, rows: int = 4096):
    """A plain training step's class sums over `b` rows, taken `rows` rows at a
    time and added: equal to one call (int32 sums are exact in any order), where
    one call of the plain version at B = 65,536 and D = 8192 would need a 98 GiB
    compare tensor."""
    out = None
    for i in range(0, b, rows):
        part = plain(slice(i, min(i + rows, b)))
        out = part if out is None else out + part
    return out


def shape_case(torch, ops, ref, sobol, name: str, key: str, gen):
    """Random inputs at a launched shape (levels 16 where the key does not say
    otherwise, as every path here runs), the call, its plain version on the same
    inputs, and the bytes and operations its bound counts (as kernel_phase counts
    them).  Returns (fn, plain fn, bytes, ops, rate args, popcounts, and the
    bounds of other counts: ``bound_ms_pr16``, popcounts counted as int32
    operations, and ``bound_ms_popc``, the CUDA cores' count where the bound is the
    tensor cores')."""
    import numpy as np

    k, dev = parse_key(key), torch.device("cuda")
    i32 = dict(generator=gen, device=dev, dtype=torch.int32)

    def rand_x(levels):
        return torch.randint(0, levels + 1, (k["B"], k["H"]), **i32)

    if name in ("encode_bundle", "fit_bundle"):
        b, h, d = k["B"], k["H"], k["D"]
        levels = 16 if k["table"] == "int8" else 256
        t = sobol.sobol_table_for_features(h, d, levels, seed=0)
        tab, x = torch.from_numpy(t.astype(k["table"])).to(dev), rand_x(levels)
        if name == "encode_bundle":
            return (lambda: ops.encode_bundle(x, tab)), (lambda: ref.encode_bundle(x, tab)), \
                b * h * 4 + h * d * tab.element_size() + b * d * 4, \
                encode_table_ops(torch, b, tab), (), 0, {}
        c = k["C"]
        lab = torch.randint(0, c, (b,), **i32)
        return (lambda: ops.fit_bundle(x, tab, lab, c)), \
            (lambda: by_rows(lambda r: ref.fit_bundle(x[r], tab, lab[r], c), b)), \
            *_RL.fit_bundle_work(b, h, d, c, tab.element_size()), (), 0, {}
    if name in ("encode_bundle_dynamic", "fit_bundle_dynamic"):
        b, h, d = k["B"], k["H"], k["D"]
        levels = {"uint8": 16, "uint16": 1024, "uint32": 2**17}[k["dir"]]
        dirs = torch.from_numpy(sobol.quantized_direction_matrix(h, levels, seed=0)).to(dev)
        x, es = rand_x(levels), dirs.element_size()
        nb = int(np.bitwise_or.reduce(dirs.to(torch.int64).cpu().numpy().ravel())).bit_length()
        if name == "encode_bundle_dynamic":
            n_ops, n_popc = encode_dynamic_ops(b, h, d, nb)
            n_bytes = b * h * 4 + h * 32 * es + b * d * 4
            return (lambda: ops.encode_bundle_dynamic(x, dirs, d)), \
                (lambda: ref.encode_bundle_dynamic(x, dirs, d)), n_bytes, n_ops, (), n_popc, \
                {"bound_ms_pr16": bound_ms(n_bytes, n_ops + n_popc)[0]}
        c = k["C"]
        lab = torch.randint(0, c, (b,), **i32)
        n_bytes = b * h * 4 + h * 32 * es + b * 4 + c * d * 4
        return (lambda: ops.fit_bundle_dynamic(x, dirs, lab, c, d)), \
            (lambda: by_rows(lambda r: ref.fit_bundle_dynamic(x[r], dirs, lab[r], c, d), b)), \
            n_bytes, b * h + c * h * d, \
            (), h * d * nb, {"bound_ms_pr16": bound_ms(n_bytes, b * h + c * h * d + h * d * nb)[0]}
    if name in ("hamming_topk", "hamming_packed"):
        b, c, w = k["B"], k["C"], k["W"]
        q = torch.randint(-2**31, 2**31 - 1, (b, w), **i32)
        rows = torch.randint(-2**31, 2**31 - 1, (c, w), **i32)
        if name == "hamming_topk":
            fn, plain = (lambda: ops.hamming_topk(q, rows, 32 * w, k["k"])), \
                (lambda: ref.hamming_topk(q, rows, 32 * w, k["k"]))
            n_bytes = b * w * 4 + c * w * 4 + 2 * b * k["k"] * 4
        else:
            fn, plain = (lambda: ops.hamming_packed(q, rows, 32 * w)), \
                (lambda: ref.hamming_packed(q, rows, 32 * w))
            n_bytes = (b * w + c * w + b * c) * 4
        return fn, plain, n_bytes, 2 * b * c * 32 * w, (BMMA_OPS_PER_S,), 0, \
            {"bound_ms_popc": popc_bound_ms(n_bytes, 2 * b * c * w, b * c * w)}
    if name == "encode_unary_mxu":
        b, kk, d = k["B"], k["K"], k["D"]
        u = (torch.rand((b, kk), generator=gen, device=dev) < 0.06).to(torch.int8)
        o = (torch.rand((d, kk), generator=gen, device=dev) < 0.5).to(torch.int8)
        return (lambda: ops.encode_unary_mxu_operands(u, o, 784)), \
            (lambda: ref.encode_unary_mxu(u, o, 784)), b * kk + d * kk + b * d * 4, \
            2 * b * kk * d, (INT8_TC_OPS_PER_S,), 0, {}
    if name == "bundle_binarize":
        b, c, d, binarize = k["B"], k["C"], k["D"], k["binarize"] == "True"
        hv = torch.randint(-784, 785, (b, d), **i32)
        lab = torch.randint(0, c, (b,), **i32)
        return (lambda: ops.bundle_binarize(hv, lab, c, binarize=binarize)), \
            (lambda: ref.bundle_binarize(hv, ref.class_onehot(lab, c), binarize=binarize)), \
            b * d * 4 + b * 4 + c * d * (1 if binarize else 4), b * d, (), 0, {}
    raise KeyError(name)


def lost_phase(torch, ops, ref, sobol) -> dict[str, dict]:
    """Each kernel's launches by shape over every path; at each shape the kernel
    held exactly against its plain version on random inputs (raises on a
    difference); each shape's device time and bound (from kernel_phase, or timed
    here on those inputs), and lost_ms = sum of launches x (device ms - bound ms)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for name in KERNELS:
        shapes: dict[str, int] = {}
        for per_path in PATH_SHAPES.values():
            for key, n in per_path[name].items():
                shapes[key] = shapes.get(key, 0) + n
        rows, max_err = [], 0
        for key, n in sorted(shapes.items(), key=lambda kv: -kv[1]):
            fn, plain, n_bytes, n_ops, rate, n_popc, earlier = shape_case(torch, ops, ref, sobol,
                                                                          name, key, gen)
            if launch_key(torch, ops, name, fn) != key:
                raise AssertionError(f"{name}: the case for {key} launched another shape")
            got, want = fn(), plain()
            if isinstance(got, torch.Tensor):
                got, want = [got], [want]
            equal, err = exact(torch, got, want)
            max_err = max(max_err, err)
            emit("path_shape_check", kernel=name, key=key, launches=n, equal=equal,
                 max_abs_err=err)
            if not equal:
                raise AssertionError(f"{name} disagrees with its plain version at {key}")
            t = BY_KEY.setdefault(name, {}).get(key)
            if t is None:
                b_ms, b_by = bound_ms(n_bytes, n_ops, *rate, n_popc=n_popc)
                rows_t: list = []
                t = BY_KEY[name][key] = dict(device_ms=device_ms(torch, fn, 20, rows_t),
                                             bound_ms=b_ms, bound_by=b_by, **earlier)
                emit("shape_time", kernel=name, key=key, **t, device_rows=rows_t[:4])
            lost = (n * (t["device_ms"] - t["bound_ms"]) if isinstance(t["device_ms"], float)
                    else "not measured")
            rows.append(dict(key=key, launches=n, **t, lost_ms=lost))
        total = sum(r["lost_ms"] for r in rows if isinstance(r["lost_ms"], float))
        out[name] = dict(launches_by_shape=shapes, shapes=rows, lost_ms=total, max_abs_err=max_err,
                         unmeasured=[r["key"] for r in rows if not isinstance(r["lost_ms"], float)])
    return out


def by_kernel_path(launches_by_shape: dict[str, int]) -> dict[str, int]:
    """Launches by the ``path=`` of their shape keys (kernels with one path: {})."""
    out: dict[str, int] = {}
    for key, n in launches_by_shape.items():
        path = parse_key(key).get("path")
        if path is not None:
            out[path] = out.get(path, 0) + n
    return out


def launch_floor(torch) -> None:
    """The device time of a one-element PyTorch fill: the least a kernel launch
    costs on the card, the floor under the latency-bound shapes."""
    t = torch.empty(1, device="cuda")
    rows: list = []
    emit("launch_floor", call="Tensor.fill_ (1 element)",
         device_ms=device_ms(torch, lambda: t.fill_(1.0), 20, rows), device_rows=rows)


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sync_all(torch, devices) -> None:
    """Synchronise every distinct card of `devices` (a mesh's cells): a
    sharded path leaves each slice's work on its own card, so a clock read
    after syncing one card only would stop before the others finish."""
    for dev in dict.fromkeys(devices):
        sync(torch, dev)


def _profile_step(torch, fn, n: int, n_wall: int = 200) -> dict:
    """Wall ms a batch of fn (each call ends with the labels on the host)
    over n_wall calls on the host clock, without the profiler (whose
    tracing adds its own host time, and a first traced graph replay pays
    a set-up of its own); then the device time of the kernels and copies
    that ``torch.profiler`` traces in n calls, by row.  The idle share is
    1 - device ms / wall ms."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n_wall):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    wall_ms = 1e3 * sum(walls) / n_wall
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        profiled_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched
    rows = [
        (e.key, e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows) / n / 1e3
    return dict(wall_ms_per_batch=wall_ms,
                wall_ms_p50=1e3 * statistics.median(walls),
                wall_ms_profiled=profiled_us / n / 1e3,
                device_ms_per_batch=device_ms if rows else "not measured",
                idle_share=1.0 - device_ms / wall_ms if rows else "not measured",
                top=[{"name": k[:90], "ms_per_batch": t / n / 1e3, "calls_per_batch": c / n}
                     for k, t, c in rows[:12]])


def replay_device_ms(torch, engine, n: int) -> float:
    """Device ms of one replay of the engine's predict graph by CUDA events
    around n back-to-back replays on the engine's stream (the host enqueues
    a replay faster than the device runs one, so the stream never idles)."""
    graph = engine._graphs[("predict", 0)].graph
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(engine.stream):
        graph.replay()
        start.record()
        for _ in range(n):
            graph.replay()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def profile_phase(torch, engine, images, label: str) -> None:
    """Steady-state predict batches of the engine, the eager step
    (``engine.execution.predict``, a pageable copy in and out) beside the
    CUDA-graph replay (``engine.predict``): wall ms a batch (host clock),
    the device time a batch by kernel (``torch.profiler``) and the device's
    idle share.
    Where the profiler lists a replay without its kernels, the replay's
    device time is read from CUDA events instead (``device_source``); the
    events' reading is reported beside the profiler's in any case.  An
    engine over several cards has no graph: its eager step alone, whose
    device time is the sum over its cards."""
    n = 16
    eager = _profile_step(
        torch, lambda: engine.execution.predict(engine.model, engine.class_words, images)
        .cpu().numpy(), n)
    if not engine.describe()["graph"]:  # a mesh over several cards runs eagerly
        emit("profile", engine=label, batch=len(images), batches=n, eager=eager, graph=None,
             devices=execution_cards(engine.describe()["execution"]))
        return
    graph = _profile_step(torch, lambda: engine.predict(images), n)
    events_ms = replay_device_ms(torch, engine, 50)
    graph["device_ms_events"] = events_ms
    graph["device_source"] = "profiler"
    if not isinstance(graph["device_ms_per_batch"], float):
        graph["device_source"] = "events (the profiler traced no kernel of the replay)"
        graph["device_ms_per_batch"] = events_ms
        graph["idle_share"] = 1.0 - events_ms / graph["wall_ms_per_batch"]
    emit("profile", engine=label, batch=len(images), batches=n, eager=eager, graph=graph,
         wall_speedup=eager["wall_ms_per_batch"] / graph["wall_ms_per_batch"],
         devices=execution_cards(engine.describe()["execution"]))


def pool_under_reload(api, ckpt, executions: list, blocks: list):
    """A ``ReplicaPool`` of one warmed engine an execution, registered from
    `ckpt` at step 0, serving `blocks` (8 requests each) from a thread while
    ``hot_reload`` promotes every replica to step 1 on this thread.  Returns
    (pool, promoted step, reload seconds, [(block index, labels, steps of its
    requests)])."""
    import threading

    registry = api.ModelRegistry()
    try:
        engines = [api.ServingEngine.from_checkpoint(ckpt, step=0, batch_size=64,
                                                     execution=ex).warmup()
                   for ex in executions]
        pool = registry.register_pool("uhd", engines, start=True)
        served, stop = [], threading.Event()

        def traffic():
            for i in range(10**6):
                if stop.is_set():
                    return
                served.append((i % len(blocks), pool.submit_block(blocks[i % len(blocks)])))
                time.sleep(0.0005)

        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        try:
            while len(served) < 64:
                time.sleep(0.001)
            t0 = time.perf_counter()
            step = registry.hot_reload("uhd", step=1)
            reload_s = time.perf_counter() - t0
            n = len(served)
            while len(served) < n + 64:
                time.sleep(0.001)
        finally:
            stop.set()
            t.join(60)
        out = [(i, [f.result(timeout=60) for f in futs], {f.trace.step for f in futs})
               for i, futs in served]
        pool.stop()
        return pool, step, reload_s, out
    finally:
        registry.shutdown()


def pool_checks(ops, pool, step, out, result, images) -> dict:
    """The pool's checks: each block's labels against the single engine of
    its step (eager, `result`'s engines), each block on one step, every
    replica at step 1 after one promotion, nothing dropped, no error."""
    want = {s: uncounted(ops, lambda e=e: e.execution.predict(
        e.model, e.class_words, images).cpu().numpy().reshape(-1, 8))
        for s, e in enumerate(result.engines)}
    one_step = all(len(steps) == 1 for _, _, steps in out)
    equal = one_step and all(labels == want[next(iter(steps))][i].tolist()
                             for i, labels, steps in out)
    merged = pool.merged_metrics()
    fields = dict(
        blocks=len(out), steps_seen=sorted({next(iter(s)) for _, _, s in out}),
        each_block_one_step=one_step, labels_equal_single_engine=equal,
        replica_steps=[r.engine.step for r in pool.replicas], pool_reloads=pool.metrics.n_reloads,
        n_dispatched=[int(c) for c in pool.n_dispatched], n_requests=merged.n_requests,
        n_errors=merged.n_errors, graph_replays=[r.engine.n_replays for r in pool.replicas])
    fields["ok"] = (step == 1 and equal and fields["replica_steps"] == [1] * len(pool.replicas)
                    and pool.metrics.n_reloads == 1 and merged.n_errors == 0
                    and merged.n_requests == 8 * len(out))
    return fields


def serve_pool_phase(torch, ops, api, result, dev):
    """A ``ReplicaPool`` of two ``DeviceExecution`` replicas and one 4-shard
    ``ShardedExecution`` replica of the card, registered from the ``uhd``
    smoke's checkpoint (step 0), serving blocks of 8 requests from a thread
    while ``hot_reload`` promotes every replica to step 1 (:func:`pool_checks`)."""
    ds = api.load_dataset("synth_mnist", n_train=1024, n_test=256)
    blocks = [ds.test_images[i : i + 8] for i in range(0, 256, 8)]
    executions = [api.DeviceExecution(device=dev), api.DeviceExecution(device=dev),
                  api.ShardedExecution(devices=[dev] * 4)]
    (pool, step, reload_s, out), launches = path_launches(
        ops, "serve_pool", ("encode_bundle", "hamming_topk", "hamming_packed"),
        lambda: pool_under_reload(api, result.engines[0].source, executions, blocks))
    checks = pool_checks(ops, pool, step, out, result, ds.test_images)
    emit("serve_pool", replicas=[r.engine.describe()["placement"] for r in pool.replicas],
         reload_s=reload_s, **checks)
    if not checks["ok"]:
        raise AssertionError("the replica pool failed its checks")
    return launches


def fresh_dir(name: str) -> Path:
    """An empty directory under build/: a watcher must see no step of an
    earlier run."""
    import shutil

    path = ROOT / "build" / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def _stage_p50s(snap: dict) -> dict:
    return {f"{k}_p50_ms": v["p50_ms"] for k, v in snap["stages"].items()}


# Each network path's endpoints (the replicas of each), and the encode and fit
# kernels that are on it and not on it.  No network path runs the baseline's
# kernels; which scoring kernel it launches follows its replicas' plan.
NETWORK_PATHS = {
    "serve_http": ((1,), ("encode_bundle", "encode_bundle_dynamic", "fit_bundle"),
                   ("fit_bundle_dynamic",)),
    "serve_http_pool": ((2,), ("encode_bundle", "encode_bundle_dynamic", "fit_bundle"),
                        ("fit_bundle_dynamic",)),
    "serve_online_uhd": ((1,), ("encode_bundle", "fit_bundle"),
                         ("encode_bundle_dynamic", "fit_bundle_dynamic")),
    "serve_online_uhd_dynamic": ((1,), ("encode_bundle_dynamic", "fit_bundle_dynamic"),
                                 ("encode_bundle", "fit_bundle")),
    "obs_agg": ((2, 1), ("encode_bundle", "fit_bundle"),
                ("encode_bundle_dynamic", "fit_bundle_dynamic")),
}
NOT_ON_NETWORK_PATHS = ("encode_unary_mxu", "bundle_binarize")


def execution_cards(desc: dict) -> list[str]:
    """The distinct devices of an execution's ``describe()``, in order."""
    return list(dict.fromkeys(desc.get("devices") or [desc["device"]]))


def network_plan(name: str, plan_executions, devices) -> dict:
    """What the network path `name` must launch and must not, and which of its
    engines capture a graph, from the replicas that ``plan_executions`` gives
    its endpoints over `devices` (the visible cards), as its launcher plans
    them.  A replica on one card captures its step and scores with
    ``hamming_topk``; one sharded over several cards runs eagerly and scores
    each shard with ``hamming_packed``."""
    replicas, kernels, absent = NETWORK_PATHS[name]
    execs = [e for n in replicas for e in plan_executions(8192, replicas=n, devices=devices)]
    cards = [execution_cards(e.describe()) for e in execs]
    sharded = any(e.placement == "sharded" for e in execs)
    pinned = any(e.placement == "device" for e in execs)
    return {
        "replicas": cards,
        "graphs": [len(c) == 1 for c in cards],
        "kernels": kernels + ("hamming_topk",) * pinned + ("hamming_packed",) * sharded,
        "absent": absent + NOT_ON_NETWORK_PATHS + ("hamming_packed",) * (not sharded),
    }


def visible_plan(name: str) -> dict:
    """:func:`network_plan` over this machine's cards."""
    from repro_torch.distributed.sharding import local_devices
    from repro_torch.serving import plan_executions

    return network_plan(name, plan_executions, local_devices())


def plan_held(plan: dict, engines: list) -> bool:
    """Whether `engines` (one a replica) lie on the plan's cards, capture a
    graph exactly where the plan says, and each graph engine replayed."""
    return ([execution_cards(e.describe()["execution"]) for e in engines] == plan["replicas"]
            and [e.describe()["graph"] for e in engines] == plan["graphs"]
            and all(e.n_replays > 0 for e, g in zip(engines, plan["graphs"]) if g))


def serve_http_phase(torch, ops, serve_http, replicas: int) -> dict:
    """``serve_http --smoke --d 8192`` (uhd, the JAX launcher's other defaults:
    1024 training images, 256 requests through 4 client threads in binary
    blocks of 8, batch 32) through the HTTP server, launches counted: the
    smoke's own checks (transport parity, 413, the watcher's mid-traffic
    promotion to the converted ``uhd_dynamic`` step 1, every label equal to
    the step-0 engine, a raw ``:search?k=3`` equal in all three columns to the
    in-process engine's), then the labels and the fit's
    class sums against the JAX package's, the promoted engines, and (a pool)
    the fleet's health and Prometheus series."""
    name = "serve_http" if replicas == 1 else "serve_http_pool"
    args = serve_http.parser().parse_args([
        "--smoke", "--d", "8192", "--device", "cuda", "--replicas", str(replicas),
        "--ckpt", str(fresh_dir(f"chip_smoke_ckpt_{name}")),
    ])
    plan = visible_plan(name)
    t0 = time.perf_counter()
    r, launches = path_launches(ops, name, plan["kernels"], lambda: serve_http.smoke(args),
                                plan["absent"])
    seconds = time.perf_counter() - t0
    labels_sha = hashlib.sha256(r.labels.astype("<i4").tobytes()).hexdigest()
    sums_sha = sha256_of(r.model.class_sums)
    snap = r.metrics
    promoted = [(e.step, e.model.cfg.encoder) for e in r.engines]
    out = dict(
        replicas=replicas, seconds=seconds, accuracy=r.accuracy, jax_accuracy=JAX_HTTP_ACCURACY,
        labels_sha256=labels_sha, jax_labels_sha256=JAX_HTTP_LABELS_SHA256,
        class_sums_sha256=sums_sha, jax_class_sums_sha256=JAX_HTTP_SHA256,
        search_k3_column0_equals_labels=bool((r.search[0][:, 0] == r.probe_labels).all()),
        promoted=promoted, promote_ms=r.health["watcher"]["last_promote_ms"],
        steps_served=r.steps_served, passes=r.n_passes,
        n_requests=snap["n_requests"], p50_ms=snap["p50_ms"], p99_ms=snap["p99_ms"],
        **_stage_p50s(snap), img_per_s=r.n_passes * len(r.labels) / r.serve_s,
        serve_s=r.serve_s, n_reloads=snap["n_reloads"], n_shed=snap["n_shed"],
        n_errors=snap["n_errors"], batch_occupancy=snap["batch_occupancy"],
        graph_replays=[r.engine0.n_replays] + [e.n_replays for e in r.engines],
        plan=plan, plan_held=plan_held(plan, r.engines),
    )
    if replicas > 1:
        out["health_replicas"] = [(x["replica"], x["step"]) for x in r.health["replicas"]]
        out["prometheus_replicas"] = sorted(
            {v for v in ("0", "1", "pool") if f'replica="{v}"' in r.prometheus})
    emit(name, **out)
    ok = (labels_sha == JAX_HTTP_LABELS_SHA256 and sums_sha == JAX_HTTP_SHA256
          and round(r.accuracy, 8) == JAX_HTTP_ACCURACY
          and out["search_k3_column0_equals_labels"]
          and promoted == [(1, "uhd_dynamic")] * replicas
          and r.steps_served.get(0, 0) > 0 and r.steps_served.get(1, 0) > 0
          and snap["n_errors"] == 0 and snap["n_reloads"] >= 1 and out["plan_held"])
    if replicas > 1:
        ok = ok and out["health_replicas"] == [(i, 1) for i in range(replicas)] \
            and out["prometheus_replicas"] == ["0", "1", "pool"]
    if not ok:
        raise AssertionError(f"the {name} phase failed its checks")
    return launches


def serve_online_phase(torch, ops, serve_online, encoder: str) -> dict:
    """``serve_online --smoke --d 8192`` for one encoder, launches counted: the
    learner trains the HTTP feedback on its own stream (kernel 3 or 4) while
    the watcher promotes; the promoted sums against offline ``partial_fit``
    (in the smoke) and the JAX package's checksum, the accuracies against
    JAX's, the shutdown order, and the learner's stage p50s."""
    name = f"serve_online_{encoder}"
    args = serve_online.parser().parse_args([
        "--smoke", "--d", "8192", "--device", "cuda", "--encoder", encoder,
        "--ckpt", str(fresh_dir(f"chip_smoke_ckpt_{name}")),
    ])
    plan = visible_plan(name)
    t0 = time.perf_counter()
    r, launches = path_launches(ops, name, plan["kernels"], lambda: serve_online.smoke(args),
                                plan["absent"])
    seconds = time.perf_counter() - t0
    promoted_sha = hashlib.sha256(r.promoted_sums.astype("<i4").tobytes()).hexdigest()
    online, snap = r.online, r.metrics
    emit(name, seconds=seconds, promoted_sha256=promoted_sha, jax_sha256=JAX_ONLINE_SHA256,
         equals_offline=sha256_of(r.offline.class_sums) == promoted_sha,
         accuracy=[r.acc_before, r.acc_after], jax_accuracy=list(JAX_ONLINE_ACCURACY),
         promoted_step=r.promoted_step, promotions=r.health["watcher"]["n_promotions"],
         promote_ms=r.health["watcher"]["last_promote_ms"],
         n_trained=online["n_trained"], n_shed=online["n_shed"],
         n_published=online["n_published"], n_reloads=snap["n_reloads"],
         **{f"{k}_p50_ms": v["p50_ms"] for k, v in online["stages"].items()},
         stage_counts={k: v["count"] for k, v in online["stages"].items()},
         feedback_to_publish_p50_ms=online["feedback_to_publish"]["p50_ms"],
         ingest_s=r.ingest_s, predict_p50_ms=snap["p50_ms"], predict_p99_ms=snap["p99_ms"],
         shutdown_order=r.shutdown_order, graph_replays=r.graph_replays)
    if not (promoted_sha == JAX_ONLINE_SHA256
            and (r.acc_before, r.acc_after) == JAX_ONLINE_ACCURACY
            and online["n_trained"] == 1024 and online["n_shed"] == 0
            and online["n_errors"] == 0 and snap["n_errors"] == 0
            and r.shutdown_order == ["learner", "watcher", "batcher"]):
        raise AssertionError(f"the {name} phase failed its checks")
    return launches


def obs_agg_phase(torch, ops, obs_agg) -> dict:
    """``obs_agg --smoke --d 8192`` on the card: a 2-replica pool and a single
    engine behind two sockets, aggregated; the smoke checks the exact merge,
    the cross-hop id, the window rate, the strict exposition parse and the
    killed target's staleness."""
    args = obs_agg.parser().parse_args(["--smoke", "--d", "8192", "--device", "cuda"])
    plan = visible_plan("obs_agg")
    t0 = time.perf_counter()
    out, launches = path_launches(ops, "obs_agg", plan["kernels"], lambda: obs_agg.smoke(args),
                                  plan["absent"])
    # the single endpoint serves half blocks: which graph engine replays varies
    engines = out["engines"]
    held = ([execution_cards(e["execution"]) for e in engines] == plan["replicas"]
            and [e["graph"] for e in engines] == plan["graphs"])
    emit("obs_agg", seconds=time.perf_counter() - t0, plan=plan, plan_held=held, **out)
    if not (out["request_rate_rps"] and out["tracked_replica"] in (0, 1) and held
            and out["graph_replays"] > 0):
        raise AssertionError("the obs_agg phase failed its checks")
    return launches


# The lm_serve phase's bound on the card's bf16 logits against the float32
# forward on the CPU at qwen3-0.6b's full width (28 layers), set before the
# first run: logits there are O(1), and bf16 keeps 8 bits of mantissa.
LM_BF16_BOUND = 0.5
LM_F32_TOL = 1e-3  # the card's float32 prefill against the CPU's
# The full-width train answers (lm_train_phase), the card against the CPU's
# float32: (loss relative, grad_norm relative) in float32 compute, and (loss
# absolute, grad_norm relative) in bf16.  Measured on an H100 (seed 0, one
# 2 x 256 batch): 7.8e-8 and 1.3e-7 in float32; 2.8e-4 and 0.15% in bf16, so
# the bf16 bounds keep a margin of about 7x.
LM_TRAIN_F32_TOL = (1e-4, 1e-3)
LM_TRAIN_BF16_TOL = (0.002, 0.01)


def _lm_batch(np, cfg, b: int, s: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(2, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.input_mode == "embeddings":
        out["embeddings"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if cfg.n_ctx_tokens:
        out["ctx"] = rng.standard_normal((b, cfg.n_ctx_tokens, cfg.d_model)).astype(np.float32)
    return out


def _lm_teacher_forced(torch, transformer, cfg, params, batch: dict, s: int, dev) -> list:
    """Prefill logits on the first s positions, then one decode step a
    further position of `batch`, each fed the batch's own token: (B, V)
    float32 logits on the CPU, one array a step."""
    on = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    cut = lambda lo, hi: {k: (v if k == "ctx" else v[:, lo:hi]) for k, v in on.items()}  # noqa: E731
    logits, state = transformer.prefill(cfg, params, cut(0, s))
    out = [logits.float().cpu().numpy()]
    for i in range(s, on["tokens"].shape[1]):
        step = cut(i, i + 1)
        extra = {k: v for k, v in step.items() if k == "embeddings"}
        logits, state = transformer.decode_step(cfg, params, state, step["tokens"], **extra)
        out.append(logits.float().cpu().numpy())
    return out


def _lm_device_ms(torch, fn, n: int) -> float:
    """Device ms a call of fn: the CUDA kernels' and copies' self time in
    one ``torch.profiler`` trace over n calls (after one untraced call),
    divided by n.  CUDA activity alone: a decode step issues thousands of
    launches, and tracing their host-side ops too (``device_ms``) takes
    longer than the phase may."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / 1e3 / n


def _lm_bf16_check(np, arch: str, card16: list, cpu16: list, cpu32: list) -> dict:
    """The card's bf16 logits against the CPU's, by the criteria of
    ``tests/test_torch_lm_bf16.py``: rtol 5e-2 / atol 1e-1 (2e-1 for the RG-LRU
    arch); xLSTM's RMS distance to the float32 logits may be up to twice the
    CPU's bf16 distance."""
    c16, p16, p32 = (np.concatenate([x.ravel() for x in xs]) for xs in (card16, cpu16, cpu32))
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))  # noqa: E731
    out = {"max_abs_err": float(np.abs(c16 - p16).max()), "rms_card_vs_f32": rms(c16 - p32),
           "rms_cpu_vs_f32": rms(p16 - p32)}
    if arch == "xlstm-1.3b":
        out["ok"] = out["rms_card_vs_f32"] <= 2 * out["rms_cpu_vs_f32"]
        return out
    atol = 2e-1 if arch == "recurrentgemma-2b" else 1e-1
    out["ok"] = all(np.allclose(c, p, rtol=5e-2, atol=atol) for c, p in zip(card16, cpu16))
    return out


def lm_serve_phase(torch, ops, smi: str, dev, cfg) -> dict:
    """The LM serving path (``repro_torch.launch.serve``) on the card, with no
    CUDA graph and no ``torch.compile``, float32 matmuls without TF32:

    * `cfg` (main: qwen3-0.6b at full width, 28 layers, d 1024, vocab
      151,936) on `dev`, weights from
      ``init_params(seed=0)``, ``Server.generate`` at the JAX launcher's
      defaults (batch 4, prompt 32, gen 16, greedy, bf16 compute) with every
      launch count read around it (the path launches none of the eight HDC
      kernels); then, teacher-forced on the generated tokens, the card's
      prefill and 15 decode steps against the port's float32 forward on the
      CPU on the same weights (max abs error under LM_BF16_BOUND; each greedy
      token equal to the CPU's argmax wherever the CPU's top-2 margin exceeds
      twice the bound), and the card's float32 prefill against the CPU's
      (LM_F32_TOL).  Timed: the one-time weight cast, the prefill, a decode
      step (p50 of 15 by CUDA events) with the cast weights and with the
      float32 masters (the per-step cast a server built on the masters would
      pay), the decode step's device time (``_lm_device_ms``) and idle
      share, the cast again with its blocks cached, generated tokens/s, and
      peak memory;
    * every arch's smoke config: prefill + 4 teacher-forced decode steps on the
      card against the CPU, in float32 (rtol/atol 1e-4, xLSTM atol 1e-3) and in
      bf16 (``_lm_bf16_check``), and ``serve_queue`` at temperature 0.7 (2
      slots, examples/serve_lm.py's mix) for qwen3-0.6b and recurrentgemma-2b
      in float32, its tokens equal to the CPU's.
    The launcher's one-card mesh is current throughout, so the MoE archs take
    the local dispatch, as ``serve.main`` makes them."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import ARCHS, get_smoke_config
    from repro_torch.distributed.sharding import get_current_mesh, set_current_mesh
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import mesh_for
    from repro_torch.models import params as pmod, transformer

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for float32 matmuls; the LM path compares float32 exactly")
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    f32 = lambda c: dataclasses.replace(c, compute_dtype="float32")  # noqa: E731
    to_cpu = lambda t: {k: to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in t.items()}  # noqa: E731
    previous = get_current_mesh()
    set_current_mesh(mesh_for(devices=[dev]))
    try:
        # --- full width -----------------------------------------------------
        b, plen, gen = 4, 32, 16
        t0 = time.perf_counter()
        params = pmod.init_params(cfg, 0, dev)
        sync(torch, dev)
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        server = serve.Server(cfg, params, b, serve.ServerConfig())
        sync(torch, dev)
        cast_ms = (time.perf_counter() - t0) * 1e3
        prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, (b, plen), dtype=np.int32)
        t0 = time.perf_counter()
        tokens, launches = path_launches(ops, "lm_serve", (), lambda: server.generate(prompts, gen),
                                         absent=tuple(KERNELS))
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = server.generate(prompts, gen)
        gen_s = time.perf_counter() - t0
        if not np.array_equal(again, tokens):
            raise AssertionError("two greedy generate calls on the card differ")
        seq = np.concatenate([prompts, tokens[:, :-1]], axis=1)
        card = _lm_teacher_forced(torch, transformer, cfg, server.params, {"tokens": seq}, plen, dev)
        card_tokens = np.stack([c.argmax(-1) for c in card], axis=1)
        if not np.array_equal(card_tokens, tokens):
            raise AssertionError("the teacher-forced card logits' argmax differs from generate's tokens")

        def events_ms(fn, n):
            times = []
            for _ in range(n):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                times.append((start, end))
            torch.cuda.synchronize()
            return [s_.elapsed_time(e_) for s_, e_ in times]

        prompt_t = torch.from_numpy(prompts).to(dev)
        prefill_ms = float(np.median(events_ms(
            lambda: transformer.prefill(cfg, server.params, {"tokens": prompt_t}), 5)))

        def decode_p50(p):
            """p50 of 15 decode steps by CUDA events, from a fresh prefill,
            and the step itself (its state advancing on each call)."""
            _, state = transformer.prefill(cfg, p, {"tokens": prompt_t})
            tok = torch.from_numpy(tokens[:, :1]).to(dev)
            box = [state]

            def step():
                box[0] = transformer.decode_step(cfg, p, box[0], tok)[1]

            step()
            return float(np.median(events_ms(step, 15))), step

        decode_ms, step = decode_p50(server.params)
        decode_device_ms = _lm_device_ms(torch, step, 3)
        decode_ms_masters, _ = decode_p50(params)
        # the cast again, its blocks cached: what a server that casts the
        # masters at every step pays for it, in device time
        cast_warm_ms = float(np.median(events_ms(lambda: transformer.cast_for_compute(cfg, params), 3)))
        peak = torch.cuda.max_memory_allocated()

        # the float32 reference on the CPU, on the same weights
        t0 = time.perf_counter()
        params_cpu = to_cpu(params)
        ref = transformer.forward_logits(f32(cfg), params_cpu, {"tokens": torch.from_numpy(seq)}).numpy()
        ref_steps = [ref[:, plen - 1 + i] for i in range(gen)]
        cpu_s = time.perf_counter() - t0
        err = max(float(np.abs(c - r).max()) for c, r in zip(card, ref_steps))
        top2 = np.sort(np.stack(ref_steps, 1), axis=-1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
        decided = margin > 2 * LM_BF16_BOUND
        agree = np.stack([r.argmax(-1) for r in ref_steps], 1) == tokens
        card32 = transformer.prefill(f32(cfg), params, {"tokens": prompt_t})[0].cpu().numpy()
        cpu32 = transformer.prefill(f32(cfg), params_cpu, {"tokens": torch.from_numpy(prompts)})[0].numpy()
        f32_err = float(np.abs(card32 - cpu32).max())
        full = {
            "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab_size, "n_params": cfg.n_params(), "batch": b, "prompt": plen,
            "gen": gen, "compute_dtype": cfg.compute_dtype, "init_s": init_s, "cast_ms": cast_ms,
            "first_generate_s": first_s, "generate_s": gen_s, "tokens_per_s": b * gen / gen_s,
            "cast_ms_warm": cast_warm_ms, "prefill_ms": prefill_ms,
            "decode_ms_p50": decode_ms, "decode_device_ms": decode_device_ms,
            "decode_idle_share": 1.0 - decode_device_ms / decode_ms,
            "decode_ms_p50_casting_each_step": decode_ms_masters,
            "max_memory_allocated": peak, "cpu_reference_s": cpu_s,
            "max_abs_err_bf16_vs_cpu_f32": err, "bound": LM_BF16_BOUND,
            "greedy_tokens_decided": int(decided.sum()), "greedy_tokens_agree": int(agree.sum()),
            "greedy_decided_disagree": int((decided & ~agree).sum()), "tokens": int(agree.size),
            "max_abs_err_f32_prefill": f32_err, "f32_tol": LM_F32_TOL,
            "launches": launches, "nvidia_smi": smi,
        }
        del server, params, params_cpu
        torch.cuda.empty_cache()

        # --- every arch at smoke size -----------------------------------------
        smoke = {}
        for arch in ARCHS:
            scfg = get_smoke_config(arch)
            p_cpu = pmod.init_params(scfg, 0, cpu)
            p_dev = pmod.init_params(scfg, 0, dev)
            batch = _lm_batch(np, scfg, 2, 16, 1)
            runs = {}
            for dt in ("float32", "bfloat16"):
                c = dataclasses.replace(scfg, compute_dtype=dt)
                runs[dt] = (_lm_teacher_forced(torch, transformer, c, p_dev, batch, 12, dev),
                            _lm_teacher_forced(torch, transformer, c, p_cpu, batch, 12, cpu))
            tol = 1e-3 if arch == "xlstm-1.3b" else 1e-4
            f32_ok = all(np.allclose(c, p, rtol=1e-4, atol=tol) for c, p in zip(*runs["float32"]))
            entry = {"f32_max_abs_err": max(float(np.abs(c - p).max()) for c, p in zip(*runs["float32"])),
                     "f32_ok": f32_ok,
                     "bf16": _lm_bf16_check(np, arch, *runs["bfloat16"], runs["float32"][1])}
            if arch in ("qwen3-0.6b", "recurrentgemma-2b"):
                rng = np.random.default_rng(0)
                requests = [rng.integers(2, scfg.vocab_size, size=n, dtype=np.int32) for n in (8, 12, 8, 10)]
                got = {}
                for where, p in (("card", p_dev), ("cpu", p_cpu)):
                    srv = serve.Server(f32(scfg), p, 2, serve.ServerConfig(temperature=0.7))
                    got[where] = srv.serve_queue(requests, gen_len=8)
                entry["serve_queue_equal"] = got["card"] == got["cpu"]
            smoke[arch] = entry
    finally:
        set_current_mesh(previous)
    full["seconds"] = time.perf_counter() - t_phase
    emit("lm_serve", full_width=full, smoke=smoke)
    bad = [a for a, e in smoke.items()
           if not (e["f32_ok"] and e["bf16"]["ok"] and e.get("serve_queue_equal", True))]
    if err >= LM_BF16_BOUND or full["greedy_decided_disagree"] or f32_err >= LM_F32_TOL or bad:
        raise AssertionError(f"the lm_serve phase failed its checks: bf16 err {err}, "
                             f"decided tokens that disagree {full['greedy_decided_disagree']}, "
                             f"f32 prefill err {f32_err}, smoke archs {bad}")
    return launches



LM_TRAIN_STEPS = 30
H100_BF16_FLOPS = _RL.PEAK_FLOPS  # dense bf16 tensor-core peak, 700 W (the data sheet)


def _lm_train_flops(cfg, b: int, s: int) -> tuple[float, float]:
    """(model FLOPs, FLOPs with the remat recompute) of one train step:
    6 N T for the weights (the tied embedding counted once, as the
    unembedding's product) plus the attention's two (S, S) products over
    the full square the port computes (2 x 2 B S^2 H hd a layer forward,
    the backward twice that); remat adds one forward of the blocks and of
    the loss chunks, so 4/3 of the model FLOPs."""
    tokens = b * s
    attn_fwd = cfg.n_layers * 4 * b * s * s * cfg.n_heads * cfg.head_dim
    fwd = 2 * cfg.n_params() * tokens + attn_fwd
    return 3 * fwd, 4 * fwd


def _train_cmd(args: list[str]) -> list[str]:
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-0.6b", "--smoke",
            "--device", "cuda", "--log-every", "1", "--ckpt-every", "10", *args]


def _train_losses(out: str) -> dict[int, float]:
    import re

    pat = re.compile(r"^step\s+(\d+) loss (\S+) ")
    return {int(m[1]): float(m[2]) for m in (pat.match(line) for line in out.splitlines()) if m}


def lm_resume_phase(torch, np, dev, steps: int = 40) -> dict:
    """``launch.train --smoke --device cuda --steps 40 --ckpt-every 10`` in a
    subprocess, sent SIGTERM once it logs step 15, then resumed to the end,
    beside an uninterrupted run: the preempted run exits 0 with a checkpoint
    at its last completed step (the step after the last it logged), the
    resumed run starts there, its batches from that step equal (bit for
    bit) the ones an uninterrupted run draws, and its losses lie within 1e-3
    of the uninterrupted run's (the embedding's backward on the card
    accumulates with atomics, so not bit for bit)."""
    import os
    import signal

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import TokenPipeline

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    d_pre, d_straight = fresh_dir("lm_resume_preempted"), fresh_dir("lm_resume_straight")
    t0 = time.perf_counter()
    straight = subprocess.Popen(_train_cmd(["--steps", str(steps), "--ckpt-dir", str(d_straight)]),
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    first = subprocess.Popen(_train_cmd(["--steps", str(steps), "--ckpt-dir", str(d_pre)]),
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = [straight, first]
    try:
        lines = []
        for line in first.stdout:
            lines.append(line)
            logged = _train_losses(line)
            if logged and max(logged) >= 15:
                first.send_signal(signal.SIGTERM)
                break
        out, err = first.communicate(timeout=300)
        logged = _train_losses("".join(lines) + out)
        saved = CheckpointManager(d_pre).latest_step()
        second = subprocess.Popen(_train_cmd(["--steps", str(steps), "--ckpt-dir", str(d_pre)]),
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(second)
        out2, err2 = second.communicate(timeout=300)
        out3, err3 = straight.communicate(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p, e in (("preempted", first, err), ("resumed", second, err2), ("straight", straight, err3)):
        if p.returncode != 0:
            raise AssertionError(f"the {name} training run exited {p.returncode}: {e[-3000:]}")
    last = max(logged)
    resumed, ref = _train_losses(out2), _train_losses(out3)
    start = min(resumed) if resumed else None
    cfg = get_smoke_config("qwen3-0.6b")
    pipe = TokenPipeline(cfg.vocab_size, 256, 8)
    batches_equal = all(
        torch.equal(pipe.batch_at(k, dev)["tokens"].cpu(),
                    TokenPipeline(cfg.vocab_size, 256, 8).host_batch(k)["tokens"])
        for k in range(last + 1, steps))
    diff = max(abs(resumed[k] - ref[k]) for k in resumed)
    out = {"steps": steps, "last_logged": last, "checkpoint_step": saved, "resumed_from": start,
           "resume_line": f"resuming from step {saved}" in out2, "batches_equal": batches_equal,
           "max_loss_diff_vs_uninterrupted": diff, "seconds": time.perf_counter() - t0}
    emit("lm_train_resume", **out)
    if not (last < steps - 1 and saved == last + 1 and start == saved and out["resume_line"]
            and batches_equal and diff <= 1e-3 and max(resumed) == steps - 1):
        raise AssertionError(f"preemption and resume on the card failed: {out}")
    return out


def lm_train_phase(torch, ops, smi: str, dev, cfg) -> dict:
    """The LM training path (``repro_torch.launch.train``) on the card, eager
    PyTorch, float32 matmuls without TF32:

    * parity at smoke width: for each of the ten archs' smoke configs in
      float32 compute, one ``make_train_step`` on the card and one on the
      CPU from the same weights and batch: loss within 1e-5 (xLSTM 1e-4),
      ``grad_norm`` within 1e-4 relative and finite, params after within
      atol 2e-3 / rtol 1e-3; then a bf16 step on the card with a finite
      loss and ``grad_norm``; gemma3's also with 8-wide attention blocks
      (the online-softmax path, with fully masked blocks);
    * answers at full width: `cfg` (qwen3-0.6b, 28 layers, d 1024, vocab
      151,936, remat, 8 loss chunks), ``init_params(seed=0)``, one 2 x 256
      ``TokenPipeline`` batch: the card's float32 loss and gradient norm
      within LM_TRAIN_F32_TOL of the CPU's float32, its bf16 ones within
      LM_TRAIN_BF16_TOL;
    * the trainer: ``train.main`` at the JAX launcher's defaults (batch 8,
      seq 256, lr 3e-4, warmup 20) for 30 steps, with launches counted
      (none of the eight HDC kernels may launch): every loss finite, the
      mean of the last 5 below the first 5; step ms p50/p90 by CUDA events
      over steps 5-29, tokens/s, the device's busy ms a step and idle share
      (``torch.profiler``, CUDA activity, steps 26-28), model FLOPs and mfu
      against 989 TFLOP/s, peak memory and the loss curve;
    * the trained state (params and AdamW moments, 7.15 GB) saved with
      ``save(blocking=False)``: the host-blocking ms, the write seconds, the
      restore seconds, every leaf restored bit for bit, then deleted;
    * preemption and resume at smoke width (``lm_resume_phase``)."""
    import dataclasses
    import shutil

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ARCHS, get_smoke_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import params as pmod
    from repro_torch.optim import OptimizerConfig, global_norm, init_opt_state
    from repro_torch.training.step import loss_and_grads, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on for float32 matmuls; the LM path compares float32 exactly")
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    f32 = lambda c: dataclasses.replace(c, compute_dtype="float32")  # noqa: E731
    to = lambda tree, d: tree_map(lambda t: t.to(d), tree)  # noqa: E731

    # --- parity at smoke width ------------------------------------------------
    parity, bad = {}, []
    ocfg = OptimizerConfig(warmup_steps=0, total_steps=10, schedule="constant")
    cases = [(a, {}) for a in ARCHS] + [("gemma3-12b", dict(attn_block_threshold=16, attn_block_q=8,
                                                           attn_block_kv=8))]
    for arch, over in cases:
        scfg = dataclasses.replace(get_smoke_config(arch), **over)
        batch = {k: torch.from_numpy(v) for k, v in _lm_batch(np, scfg, 2, 16, 1).items()}
        runs = {}
        for where, d in (("card", dev), ("cpu", cpu)):
            p = pmod.init_params(scfg, 0, cpu)
            p = to(p, d)
            p, _, m = make_train_step(f32(scfg), ocfg)(p, init_opt_state(p), to(batch, d), 0)
            runs[where] = (to(p, cpu), {k: v.item() for k, v in m.items()})
        p16 = to(pmod.init_params(scfg, 0, cpu), dev)
        _, _, m16 = make_train_step(scfg, ocfg)(p16, init_opt_state(p16), to(batch, dev), 0)
        (pc, mc), (pp, mp) = runs["card"], runs["cpu"]
        tol = 1e-4 if arch == "xlstm-1.3b" else 1e-5
        err = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(pc), tree_leaves(pp)))
        close = all(torch.allclose(a, b, atol=2e-3, rtol=1e-3) for a, b in zip(tree_leaves(pc), tree_leaves(pp)))
        name = arch + (" blocked" if over else "")
        parity[name] = {"loss_err": abs(mc["loss"] - mp["loss"]),
                        "grad_norm_rel_err": abs(mc["grad_norm"] - mp["grad_norm"]) / mp["grad_norm"],
                        "params_max_abs_err": err, "bf16_loss": m16["loss"].item(),
                        "bf16_grad_norm": m16["grad_norm"].item()}
        e = parity[name]
        if not (e["loss_err"] <= tol and e["grad_norm_rel_err"] <= 1e-4 and close
                and np.isfinite([mc["grad_norm"], e["bf16_loss"], e["bf16_grad_norm"]]).all()):
            bad.append(name)
    emit("lm_train_parity", archs=parity, failed=bad)
    if bad:
        raise AssertionError(f"lm_train parity failed for {bad}")

    # --- answers at full width ------------------------------------------------
    t0 = time.perf_counter()
    params_cpu = pmod.init_params(cfg, 0, cpu)
    batch = TokenPipeline(cfg.vocab_size, 256, 2).host_batch(0)
    init_s = time.perf_counter() - t0

    def answer(c, p, b):
        loss, _, grads = loss_and_grads(c, p, b)
        return loss.item(), global_norm(grads).item()

    t0 = time.perf_counter()
    ref_loss, ref_gn = answer(f32(cfg), params_cpu, batch)
    cpu_s = time.perf_counter() - t0
    params_dev = to(params_cpu, dev)
    card32 = answer(f32(cfg), params_dev, to(batch, dev))
    card16 = answer(cfg, params_dev, to(batch, dev))
    del params_dev
    answers = {"batch": [2, 256], "cpu_f32": [ref_loss, ref_gn], "card_f32": list(card32),
               "card_bf16": list(card16), "f32_loss_rel_err": abs(card32[0] - ref_loss) / ref_loss,
               "f32_grad_norm_rel_err": abs(card32[1] - ref_gn) / ref_gn,
               "bf16_loss_abs_err": abs(card16[0] - ref_loss),
               "bf16_grad_norm_rel_err": abs(card16[1] - ref_gn) / ref_gn,
               "tol_f32": LM_TRAIN_F32_TOL, "tol_bf16": LM_TRAIN_BF16_TOL,
               "init_s": init_s, "cpu_reference_s": cpu_s}
    emit("lm_train_answers", **answers)
    if not (answers["f32_loss_rel_err"] <= LM_TRAIN_F32_TOL[0]
            and answers["f32_grad_norm_rel_err"] <= LM_TRAIN_F32_TOL[1]
            and answers["bf16_loss_abs_err"] <= LM_TRAIN_BF16_TOL[0]
            and answers["bf16_grad_norm_rel_err"] <= LM_TRAIN_BF16_TOL[1]):
        raise AssertionError(f"the full-width training answers are off: {answers}")
    del params_cpu

    # --- the trainer at full width ------------------------------------------------
    b, s = 8, 256
    events, losses, state = [], [], {}
    prof = profile(activities=[ProfilerActivity.CUDA])

    def on_step(step, params, opt_state, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        losses.append(metrics["loss"].item())
        if step == 25:
            torch.cuda.synchronize()
            prof.start()
        elif step == 28:
            torch.cuda.synchronize()
            prof.stop()
        state.update(params=params, opt=opt_state)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", cfg.name, "--steps", str(LM_TRAIN_STEPS), "--batch", str(b), "--seq", str(s)]
    t0 = time.perf_counter()
    rc, launches = path_launches(ops, "lm_train", (), lambda: train.main(argv, on_step=on_step),
                                 absent=tuple(KERNELS))
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    step_ms = [events[i - 1].elapsed_time(events[i]) for i in range(5, LM_TRAIN_STEPS)]
    window_ms = events[25].elapsed_time(events[28]) / 3
    on_card = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in on_card) / 1e3 / 3
    top = sorted(on_card, key=lambda e: -e.self_device_time_total)[:15]
    model_flops, remat_flops = _lm_train_flops(cfg, b, s)
    p50, p90 = float(np.percentile(step_ms, 50)), float(np.percentile(step_ms, 90))
    trainer = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
        "n_params": cfg.n_params(), "batch": b, "seq": s, "steps": LM_TRAIN_STEPS, "rc": rc,
        "remat": cfg.remat, "remat_policy": cfg.remat_policy, "loss_seq_chunks": cfg.loss_seq_chunks,
        "seconds": train_s, "step_ms_p50": p50, "step_ms_p90": p90, "tokens_per_s": b * s / (p50 / 1e3),
        "device_ms_per_step": device_ms, "wall_ms_profiled_steps": window_ms,
        "idle_share": 1.0 - device_ms / window_ms,
        "device_launches_per_step": sum(e.count for e in on_card) / 3,
        "device_top": [{"name": e.key[:90], "ms_per_step": e.self_device_time_total / 1e3 / 3,
                        "calls_per_step": e.count / 3} for e in top],
        "model_flops": model_flops,
        "model_flops_with_remat": remat_flops, "mfu": model_flops / (p50 / 1e3) / H100_BF16_FLOPS,
        "mfu_with_remat": remat_flops / (p50 / 1e3) / H100_BF16_FLOPS,
        "max_memory_allocated": peak, "losses": losses, "launches": launches, "nvidia_smi": smi,
    }
    emit("lm_train", **trainer)
    LM_REF["train_losses"] = list(losses)
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if rc != 0 or not np.isfinite(losses).all() or not last5 < first5:
        raise AssertionError(f"the full-width trainer failed: rc {rc}, first {first5}, last {last5}")

    # --- the trained state, checkpointed --------------------------------------
    ckpt_dir = fresh_dir("lm_train_ckpt")
    tree = {"params": state["params"], "opt": state["opt"]}
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    free = shutil.disk_usage(ckpt_dir).free
    emit("lm_train_ckpt_disk", state_bytes=n_bytes, free_bytes=free)
    try:
        mgr = CheckpointManager(ckpt_dir, keep_n=1)
        t0 = time.perf_counter()
        mgr.save(LM_TRAIN_STEPS, tree, blocking=False)
        host_ms = (time.perf_counter() - t0) * 1e3
        mgr.wait()
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = mgr.restore(LM_TRAIN_STEPS, tree)
        restore_s = time.perf_counter() - t0
        exact = all(np.array_equal(np.asarray(r), t.cpu().numpy())
                    for r, t in zip(tree_leaves(restored), tree_leaves(tree)))
        del restored
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = {"state_bytes": n_bytes, "free_bytes_before": free, "host_blocking_ms": host_ms,
            "write_s": write_s, "restore_s": restore_s, "bit_exact": exact}
    emit("lm_train_ckpt", **ckpt)
    if not exact:
        raise AssertionError("the full-width checkpoint did not restore bit for bit")
    del tree, state
    torch.cuda.empty_cache()

    resume = lm_resume_phase(torch, np, dev)
    out = {"seconds": time.perf_counter() - t_phase, "trainer": {k: trainer[k] for k in (
        "step_ms_p50", "step_ms_p90", "tokens_per_s", "device_ms_per_step", "idle_share", "mfu",
        "max_memory_allocated")}, "checkpoint": ckpt, "resume_seconds": resume["seconds"]}
    emit("lm_train_phase", **out)
    return launches


# What the one-device LM phases leave for lm_mesh_phase to hold the sharded
# launchers to: the full-width trainer's losses at seed 0 (lm_train_phase).
LM_REF: dict = {}
LM_MESH_STEPS = 5
# The sharded trainer's bf16 losses against the one-device trainer's at the same
# seed, step by step: 2.8e-4 apart on one card (the one-hot loss form and the
# DTensor dispatch order the same bf16 products otherwise), and the band leaves
# room for the reduction order over several cards; the served tokens are held
# off near-ties as lm_serve holds the card to the CPU (a row may part only
# where the one-device top-2 margin is within 2 * LM_BF16_BOUND).
LM_MESH_LOSS_BAND = 0.01


def _lm_mesh_run(module: str | Path, args: list[str], n: int, out: Path, timeout: int = 600,
                 env_extra: dict | None = None):
    """``python -m torch.distributed.run --standalone --nproc-per-node n -m
    <module> <args> --metrics-out <out>`` (or the script at the path
    `module`, `env_extra` added to its environment); each rank's metrics
    record, and rank 0's standard output."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    target = [str(module)] if isinstance(module, Path) else ["-m", module]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", *target, *args, "--metrics-out", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{module} on {n} processes exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    recs = [json.loads(Path(f"{out}.rank{r}.json").read_text()) for r in range(n)]
    return recs, proc.stdout, seconds


def _lm_greedy_margins(torch, np, cfg, dev, prompts, gen: int, params=None):
    """The one-device ``Server``'s greedy tokens on `dev` (`params`, default
    init_params(seed=0)) and each step's top-2 logit margin."""
    from repro_torch.launch.serve import Server, ServerConfig
    from repro_torch.models import params as pmod

    if params is None:
        params = pmod.init_params(cfg, 0, dev)
    server = Server(cfg, params, len(prompts), ServerConfig())
    logits, state = server._prefill(prompts)
    toks, margins = [], []
    for i in range(gen):
        if i:
            logits, state = server._decode(state, toks[-1][:, None])
        top = torch.topk(logits.float(), 2, dim=-1).values
        margins.append((top[:, 0] - top[:, 1]).cpu().numpy())
        toks.append(torch.argmax(logits, -1).to(torch.int32))
    out = torch.stack(toks, 1).cpu().numpy(), np.stack(margins, 1)
    del server
    torch.cuda.empty_cache()
    return out


def _parted(np, got, want, margins) -> dict:
    """{row: the first step where `got` parts from `want`, and the one-device
    top-2 margin there}."""
    parted = {}
    for row in range(len(want)):
        diff = np.flatnonzero(got[row] != want[row])
        if len(diff):
            parted[row] = {"step": int(diff[0]), "margin": float(margins[row, diff[0]])}
    return parted


def lm_mesh_phase(torch, np, smi: str, dev, cfg) -> dict:
    """The LM paths laid out over the cards, one process a card
    (``python -m torch.distributed.run --standalone --nproc-per-node N``, N =
    min(cards, 4), NCCL), at full width (`cfg`: qwen3-0.6b):

    * ``launch.train`` at the JAX launcher's defaults (batch 8 x 256, lr 3e-4,
      warmup 20, seed 0) for LM_MESH_STEPS steps: every leaf of params and
      AdamW moments on every rank is a ``DTensor`` (on one card too: the
      group is up, so the DTensor path is the one taken), each step's loss
      within LM_MESH_LOSS_BAND of the one-device trainer's (lm_train_phase,
      same seed; warmup keeps the two schedules equal), step ms p50 by CUDA
      events, tokens/s over the global batch, peak memory per rank;
    * ``launch.serve`` at its defaults (batch 4, prompt 32, gen 16, greedy):
      the weights ``DTensor``s, every rank's tokens those of rank 0, and
      rank 0's equal to the one-device ``Server``'s on the card wherever the
      one-device top-2 margin exceeds 2 * LM_BF16_BOUND (a row may part only
      at a near-tie, and is not held after it); seconds, tokens/s and the
      one-device top-2 margin of every step.
    The HDC kernels are not on these paths (the processes load none)."""
    t_phase = time.perf_counter()
    n = min(torch.cuda.device_count(), 4)
    d = fresh_dir("lm_mesh")
    ref = LM_REF["train_losses"][:LM_MESH_STEPS]

    recs, out, seconds = _lm_mesh_run(
        "repro_torch.launch.train", ["--arch", cfg.name, "--steps", str(LM_MESH_STEPS),
                                     "--log-every", "1"], n, d / "train")
    b, s = recs[0]["batch"], recs[0]["seq"]
    leaves = recs[0]["leaves"]
    not_sharded = [k for r in recs for k, v in r["leaves"].items() if v["type"] != "DTensor"]
    diffs = [abs(a - w) for a, w in zip(recs[0]["losses"], ref, strict=True)]
    step_ms = [float(np.percentile(r["step_ms"], 50)) for r in recs]
    train = {
        "n": n, "mesh": recs[0]["mesh"], "batch": b, "seq": s, "steps": LM_MESH_STEPS,
        "seconds": seconds, "losses": recs[0]["losses"], "one_device_losses": ref,
        "max_loss_diff": max(diffs), "band": LM_MESH_LOSS_BAND,
        "losses_equal_across_ranks": all(r["losses"] == recs[0]["losses"] for r in recs),
        "step_ms_p50_per_rank": step_ms, "tokens_per_s": b * s / (max(step_ms) / 1e3),
        "max_memory_allocated_per_rank": [r["max_memory_allocated"] for r in recs],
        "leaf_types": sorted({v["type"] for v in leaves.values()}),
        "placements": {k: v["placements"] for k, v in leaves.items()},
        "not_dtensor": not_sharded, "stdout_tail": out.splitlines()[-3:], "nvidia_smi": smi,
    }
    emit("lm_mesh_train", **train)
    if not (not not_sharded and max(diffs) <= LM_MESH_LOSS_BAND
            and train["losses_equal_across_ranks"] and np.isfinite(recs[0]["losses"]).all()):
        raise AssertionError(f"the sharded trainer failed its checks: {train}")

    recs, out, seconds = _lm_mesh_run("repro_torch.launch.serve", ["--arch", cfg.name], n,
                                      d / "serve")
    r0 = recs[0]
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, (r0["batch"], r0["prompt_len"]),
                                                dtype=np.int32)
    want, margins = _lm_greedy_margins(torch, np, cfg, dev, prompts, r0["gen"])
    parted = _parted(np, np.asarray(r0["tokens"]), want, margins)
    serve = {
        "n": n, "mesh": r0["mesh"], "seconds": seconds, "generate_s": r0["seconds"],
        "tokens_per_s": r0["tokens_per_s"], "tokens": r0["tokens"], "one_device": want.tolist(),
        "rows_parted": parted, "near_tie": 2 * LM_BF16_BOUND,
        "one_device_margins": np.round(margins, 4).tolist(),
        "tokens_equal_across_ranks": all(r["tokens"] == r0["tokens"] for r in recs),
        "leaf_types": sorted({v["type"] for v in r0["leaves"].values()}),
        "max_memory_allocated_per_rank": [r["max_memory_allocated"] for r in recs],
        "stdout_tail": out.splitlines()[-2:], "nvidia_smi": smi,
    }
    emit("lm_mesh_serve", **serve)
    if not (serve["leaf_types"] == ["DTensor"] and serve["tokens_equal_across_ranks"]
            and all(p["margin"] <= 2 * LM_BF16_BOUND for p in parted.values())):
        raise AssertionError(f"the sharded server failed its checks: {serve}")
    emit("lm_mesh_phase", seconds=time.perf_counter() - t_phase, n=n)
    return {k: 0 for k in KERNELS}


# The lm_mesh_moe phase's trainer at full width with a depth cut (the launcher has
# no depth option, as JAX's has none): one process a card under torchrun, the
# args arch, layers, steps, batch, seq, and --metrics-out PATH.
LM_MESH_MOE_TRAIN = """
import dataclasses, sys
import torch
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import ShardingRules, set_current_mesh
from repro_torch.launch.mesh import init_distributed, mesh_for
from repro_torch.launch.train import StepClock, leaf_layouts, pipeline_for, write_metrics
from repro_torch.models import params as pmod
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import OptimizerConfig, init_opt_state
from repro_torch.training.step import make_train_step

arch, layers, steps, batch, seq = sys.argv[1], *map(int, sys.argv[2:6])
dev = init_distributed(None)
cfg = dataclasses.replace(get_config(arch), n_layers=layers, grad_accum=1)
mesh = mesh_for()
set_current_mesh(mesh)
rules = ShardingRules(fsdp=cfg.fsdp)
params = pmod.init_params(cfg, 0, mesh=mesh, rules=rules)
opt = init_opt_state(params)
step_fn = make_train_step(cfg, OptimizerConfig(lr=3e-4, warmup_steps=20, total_steps=steps))
pipe = pipeline_for(cfg, ShapeConfig("cli", seq, batch, "train"), seed=0)
torch.cuda.reset_peak_memory_stats(dev)
clock, losses = StepClock(dev), []
clock.tick()
for step in range(steps):
    params, opt, m = step_fn(params, opt, pipe.sharded_batch_at(step, mesh, rules), step)
    losses.append(float(m["loss"]))
    clock.tick()
write_metrics(sys.argv[7], dev, mesh, {
    "arch": cfg.name, "n_layers": layers, "n_params": cfg.n_params(), "batch": batch,
    "seq": seq, "losses": losses, "step_ms": clock.ms(),
    "leaves": leaf_layouts({"params": params, "opt": opt})})
torch.distributed.destroy_process_group()
"""
LM_MESH_MOE_ARCH = "olmoe-1b-7b"
# The depth cut of the full-width MoE training on one card: 4 of olmoe-1b-7b's
# 16 layers (about 1.88 B parameters and 30 GB of float32 params, gradients and
# AdamW moments); the full depth's 110 GB of state does not fit one 80 GB card.
LM_MESH_MOE_TRAIN_LAYERS = 4


def lm_mesh_moe_phase(torch, np, smi: str, dev) -> dict:
    """The MoE blocks laid out over the cards (slice 10b), one process a card
    (``torch.distributed.run --standalone --nproc-per-node N``, N = min(cards,
    4), NCCL), olmoe-1b-7b at full width (64 experts, top-8, d 2048):

    * ``launch.serve --arch olmoe-1b-7b`` at its defaults (batch 4, prompt 32,
      gen 16, greedy, bf16) at full depth (16 layers): every leaf a
      ``DTensor`` with the rules' placements (JAX's spec: the experts'
      ``mlp`` dim on ``model``; each layer gathers its experts on ``model``
      and exchanges the tokens with their owners by all-to-all), every
      rank's tokens rank 0's, and rank 0's equal to the one-device
      ``Server``'s on the card wherever the one-device top-2 margin exceeds
      2 * LM_BF16_BOUND.  The one-device server runs under a current mesh of
      the card in the launcher's shape, so that its MoE routes each batch
      shard as the ranks do (``moe._moe_ffn_local``).  Seconds, tokens/s and
      peak memory per rank;
    * training at full width with the depth cut to LM_MESH_MOE_TRAIN_LAYERS
      (``LM_MESH_MOE_TRAIN``, written into the phase's directory): 5 steps
      at batch 8 x 256, each loss within LM_MESH_LOSS_BAND of the same
      config's one-device run in this process (seed 0, the same batches,
      the same per-shard dispatch); step ms p50 by CUDA events, tokens/s,
      peak memory per rank.
    The one-device server's weights are drawn on the host in a thread while
    the ranks serve.  The HDC kernels are not on these paths (the processes
    load none)."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Mesh, get_current_mesh, set_current_mesh
    from repro_torch.launch.train import StepClock, pipeline_for
    from repro_torch.models import params as pmod
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.training.step import make_train_step
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    n = min(torch.cuda.device_count(), 4)
    d = fresh_dir("lm_mesh_moe")
    cfg = get_config(LM_MESH_MOE_ARCH)
    pool = ThreadPoolExecutor(1)
    drawn = pool.submit(pmod.init_params, cfg, 0, "cpu")
    pool.shutdown(wait=False)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved(dev)
    previous = get_current_mesh()

    def like_ranks(shape: dict):
        """A mesh of this card in the ranks' shape (one process, every cell)."""
        return Mesh(np.array([dev] * n, dtype=object).reshape(tuple(shape.values())),
                    tuple(shape))

    recs, out, seconds = _lm_mesh_run("repro_torch.launch.serve", ["--arch", cfg.name], n,
                                      d / "serve", timeout=900)
    r0 = recs[0]
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, (r0["batch"], r0["prompt_len"]),
                                                dtype=np.int32)
    t0 = time.perf_counter()
    set_current_mesh(like_ranks(r0["mesh"]))
    try:
        want, margins = _lm_greedy_margins(torch, np, cfg, dev, prompts, r0["gen"],
                                           tree_map(lambda t: t.to(dev), drawn.result()))
    finally:
        set_current_mesh(previous)
    one_device_s = time.perf_counter() - t0
    parted = _parted(np, np.asarray(r0["tokens"]), want, margins)
    experts = {k: v["placements"] for k, v in r0["leaves"].items()
               if k.rsplit("/", 1)[-1] in ("w_gate", "w_up", "w_down")}
    serve = {
        "arch": cfg.name, "n": n, "mesh": r0["mesh"], "n_layers": cfg.n_layers,
        "n_params": cfg.n_params(), "seconds": seconds, "generate_s": r0["seconds"],
        "tokens_per_s": r0["tokens_per_s"], "tokens": r0["tokens"], "one_device": want.tolist(),
        "one_device_s": one_device_s, "rows_parted": parted, "near_tie": 2 * LM_BF16_BOUND,
        "one_device_margins": np.round(margins, 4).tolist(),
        "tokens_equal_across_ranks": all(r["tokens"] == r0["tokens"] for r in recs),
        "leaf_types": sorted({v["type"] for v in r0["leaves"].values()}),
        "expert_placements": experts,
        "max_memory_allocated_per_rank": [r["max_memory_allocated"] for r in recs],
        "main_process_reserved": held, "stdout_tail": out.splitlines()[-2:], "nvidia_smi": smi,
    }
    emit("lm_mesh_moe_serve", **serve)
    if not (serve["leaf_types"] == ["DTensor"] and serve["tokens_equal_across_ranks"]
            and experts and all(p["margin"] <= 2 * LM_BF16_BOUND for p in parted.values())):
        raise AssertionError(f"the sharded MoE server failed its checks: {serve}")

    layers, steps, b, s = LM_MESH_MOE_TRAIN_LAYERS, LM_MESH_STEPS, 8, 256
    script = d / "train_moe.py"
    script.write_text(LM_MESH_MOE_TRAIN)
    recs, out, seconds = _lm_mesh_run(script, [cfg.name, str(layers), str(steps), str(b), str(s)],
                                      n, d / "train", timeout=900)
    cut = dataclasses.replace(cfg, n_layers=layers, grad_accum=1)
    t0 = time.perf_counter()
    set_current_mesh(like_ranks(recs[0]["mesh"]))
    try:
        params = pmod.init_params(cut, 0, dev)
        opt = init_opt_state(params)
        step_fn = make_train_step(cut, OptimizerConfig(lr=3e-4, warmup_steps=20, total_steps=steps))
        pipe = pipeline_for(cut, ShapeConfig("cli", s, b, "train"), seed=0)
        torch.cuda.reset_peak_memory_stats(dev)
        clock, ref = StepClock(dev), []
        clock.tick()
        for step in range(steps):
            params, opt, m = step_fn(params, opt, pipe.batch_at(step, dev), step)
            ref.append(float(m["loss"]))
            clock.tick()
        one_ms = clock.ms()
        one_peak = torch.cuda.max_memory_allocated(dev)
    finally:
        set_current_mesh(previous)
    del params, opt, step_fn
    torch.cuda.empty_cache()
    one_device_s = time.perf_counter() - t0
    diffs = [abs(a - w) for a, w in zip(recs[0]["losses"], ref, strict=True)]
    step_ms = [float(np.percentile(r["step_ms"], 50)) for r in recs]
    not_sharded = [k for r in recs for k, v in r["leaves"].items() if v["type"] != "DTensor"]
    train = {
        "arch": cfg.name, "n": n, "mesh": recs[0]["mesh"], "n_layers": layers,
        "depth_cut": f"{layers} of {cfg.n_layers} layers", "n_params": recs[0]["n_params"],
        "batch": b, "seq": s, "steps": steps, "seconds": seconds, "losses": recs[0]["losses"],
        "one_device_losses": ref, "max_loss_diff": max(diffs), "band": LM_MESH_LOSS_BAND,
        "losses_equal_across_ranks": all(r["losses"] == recs[0]["losses"] for r in recs),
        "step_ms_all_rank0": recs[0]["step_ms"], "step_ms_p50_per_rank": step_ms,
        "tokens_per_s": b * s / (max(step_ms) / 1e3),
        "max_memory_allocated_per_rank": [r["max_memory_allocated"] for r in recs],
        "one_device_step_ms_p50": float(np.percentile(one_ms, 50)),
        "one_device_max_memory_allocated": one_peak, "one_device_s": one_device_s,
        "not_dtensor": not_sharded, "stdout_tail": out.splitlines()[-3:], "nvidia_smi": smi,
    }
    emit("lm_mesh_moe_train", **train)
    if not (not not_sharded and max(diffs) <= LM_MESH_LOSS_BAND
            and train["losses_equal_across_ranks"] and np.isfinite(recs[0]["losses"]).all()):
        raise AssertionError(f"the sharded MoE trainer failed its checks: {train}")
    emit("lm_mesh_moe_phase", seconds=time.perf_counter() - t_phase, n=n)
    return {k: 0 for k in KERNELS}


# The archs of the lm_mesh_10c phase, served over the cards at full width and depth
LM_MESH_10C_SERVE = ("recurrentgemma-2b", "xlstm-1.3b")
# Its trainer, at full width and depth: recurrentgemma-2b's 2.89 B parameters take
# 16 bytes each as float32 masters, gradients and AdamW's m and v (46.3 GB), and
# the per-layer remat keeps one layer's activations of a 2 x 1024 batch; one 80 GB
# card holds that, so the depth is not cut.
LM_MESH_10C_TRAIN = ("recurrentgemma-2b", 2, 1024)
# Each sharded training loss within this of the one-device step's (tighter than
# LM_MESH_LOSS_BAND: the full-depth recurrentgemma-2b losses part by under 0.0018)
LM_MESH_10C_LOSS_BAND = 0.002


def lm_mesh_10c_phase(torch, np, smi: str, dev) -> dict:
    """The RG-LRU and xLSTM blocks laid out over the cards (slice 10c), one
    process a card (``torch.distributed.run --standalone --nproc-per-node N``,
    N = min(cards, 4), NCCL), each mixer on its rank's batch shard and its
    channels or heads (``models.per_shard``):

    * ``launch.serve`` at its defaults (batch 4, prompt 32, gen 16, greedy,
      bf16) for recurrentgemma-2b (26 layers, d 2560, rec width 2560, vocab
      256,000) and xlstm-1.3b (48 layers, d 2048, 4 heads) at full width and
      depth: every leaf a ``DTensor``, every rank's tokens rank 0's, and
      rank 0's equal to the one-device ``Server``'s on the card wherever the
      one-device top-2 margin exceeds 2 * LM_BF16_BOUND; seconds, tokens/s and
      peak memory per rank beside the one-device server's seconds;
    * recurrentgemma-2b trained at full width and depth (``LM_MESH_MOE_TRAIN``'s
      script, LM_MESH_10C_TRAIN: 5 steps at batch 2 x 1024), each loss within
      LM_MESH_10C_LOSS_BAND of the one-device step's in this process (seed 0,
      the same batches, the weights the one-device server used); step ms p50
      by CUDA events beside the one-device p50, each also over steps 2-5
      alone (the first step's warm-up out), and peak GB of each.
    The one-device weights are drawn on the host in a thread while the
    ranks run (the draw is host work; the ranks' timed work is the card's),
    and moved to the card after them.  Every record carries the card's name
    and power limit.  The HDC kernels are not on these paths (the processes
    load none)."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import get_config
    from repro_torch.launch.train import StepClock, pipeline_for
    from repro_torch.models import params as pmod
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import OptimizerConfig, init_opt_state
    from repro_torch.training.step import make_train_step
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    n = min(torch.cuda.device_count(), 4)
    d = fresh_dir("lm_mesh_10c")
    pool = ThreadPoolExecutor(1)
    drawn = {name: pool.submit(pmod.init_params, get_config(name), 0, "cpu")
             for name in LM_MESH_10C_SERVE}
    pool.shutdown(wait=False)
    arch, b, s = LM_MESH_10C_TRAIN
    steps = LM_MESH_STEPS
    # what this process still holds of the earlier phases, with the card's
    # 80 GB shared with a rank that peaks near 52 GB
    gc.collect()
    torch.cuda.empty_cache()
    held = {"main_process_allocated": torch.cuda.memory_allocated(dev),
            "main_process_reserved": torch.cuda.memory_reserved(dev)}
    emit("lm_mesh_10c_start", **held, nvidia_smi=smi)
    script = d / "train.py"
    script.write_text(LM_MESH_MOE_TRAIN)
    tcfg = get_config(arch)
    # expandable segments: the rank's peak fits without the free blocks a
    # fixed-size cache strands between its steps' allocations
    train_recs, train_out, train_s = _lm_mesh_run(
        script, [arch, str(tcfg.n_layers), str(steps), str(b), str(s)], n, d / "train",
        timeout=900, env_extra={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    for name in LM_MESH_10C_SERVE:
        cfg = get_config(name)
        recs, out, seconds = _lm_mesh_run("repro_torch.launch.serve", ["--arch", name], n,
                                          d / f"serve_{name}", timeout=900)
        r0 = recs[0]
        prompts = np.random.default_rng(0).integers(2, cfg.vocab_size,
                                                    (r0["batch"], r0["prompt_len"]),
                                                    dtype=np.int32)
        t0 = time.perf_counter()
        params = tree_map(lambda t: t.to(dev), drawn.pop(name).result())
        want, margins = _lm_greedy_margins(torch, np, cfg, dev, prompts, r0["gen"], params)
        one_device_s = time.perf_counter() - t0
        parted = _parted(np, np.asarray(r0["tokens"]), want, margins)
        serve = {
            "arch": name, "n": n, "mesh": r0["mesh"], "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "n_params": cfg.n_params(), "seconds": seconds,
            "generate_s": r0["seconds"], "tokens_per_s": r0["tokens_per_s"],
            "tokens": r0["tokens"], "one_device": want.tolist(),
            "one_device_s": one_device_s, "rows_parted": parted, "near_tie": 2 * LM_BF16_BOUND,
            "one_device_margins": np.round(margins, 4).tolist(),
            "tokens_equal_across_ranks": all(r["tokens"] == r0["tokens"] for r in recs),
            "leaf_types": sorted({v["type"] for v in r0["leaves"].values()}),
            "max_memory_allocated_per_rank": [r["max_memory_allocated"] for r in recs],
            "stdout_tail": out.splitlines()[-2:], "nvidia_smi": smi,
        }
        emit("lm_mesh_10c_serve", **serve)
        if not (serve["leaf_types"] == ["DTensor"] and serve["tokens_equal_across_ranks"]
                and all(p["margin"] <= 2 * LM_BF16_BOUND for p in parted.values())):
            raise AssertionError(f"the sharded {name} server failed its checks: {serve}")
        if name != arch:
            del params
            torch.cuda.empty_cache()
            continue
        # the one-device trainer from the same weights (seed 0), updated in place
        t0 = time.perf_counter()
        tcfg = dataclasses.replace(cfg, grad_accum=1)
        opt = init_opt_state(params)
        step_fn = make_train_step(tcfg, OptimizerConfig(lr=3e-4, warmup_steps=20,
                                                        total_steps=steps))
        pipe = pipeline_for(tcfg, ShapeConfig("cli", s, b, "train"), seed=0)
        torch.cuda.reset_peak_memory_stats(dev)
        clock, ref = StepClock(dev), []
        clock.tick()
        for step in range(steps):
            params, opt, m = step_fn(params, opt, pipe.batch_at(step, dev), step)
            ref.append(float(m["loss"]))
            clock.tick()
        one_ms = clock.ms()
        one_peak = torch.cuda.max_memory_allocated(dev)
        del params, opt, step_fn
        torch.cuda.empty_cache()
        one_train_s = time.perf_counter() - t0
    diffs = [abs(a - w) for a, w in zip(train_recs[0]["losses"], ref, strict=True)]
    step_ms = [float(np.percentile(r["step_ms"], 50)) for r in train_recs]
    # steps 2.. alone: the first step's warm-up (allocator, NCCL, autotuning)
    steady_ms = [float(np.percentile(r["step_ms"][1:], 50)) for r in train_recs]
    one_steady_ms = float(np.percentile(one_ms[1:], 50))
    not_sharded = [k for r in train_recs for k, v in r["leaves"].items() if v["type"] != "DTensor"]
    train = {
        "arch": arch, "n": n, "mesh": train_recs[0]["mesh"], "n_layers": tcfg.n_layers,
        "depth_cut": None, "n_params": train_recs[0]["n_params"], "batch": b, "seq": s,
        "steps": steps, "seconds": train_s, "losses": train_recs[0]["losses"],
        "one_device_losses": ref, "max_loss_diff": max(diffs), "band": LM_MESH_10C_LOSS_BAND,
        "losses_equal_across_ranks": all(r["losses"] == train_recs[0]["losses"]
                                         for r in train_recs),
        "step_ms_all_rank0": train_recs[0]["step_ms"], "step_ms_p50_per_rank": step_ms,
        "one_device_step_ms_p50": float(np.percentile(one_ms, 50)),
        "one_device_step_ms_all": list(one_ms),
        "steady_step_ms_p50_per_rank": steady_ms, "one_device_steady_step_ms_p50": one_steady_ms,
        "steady_step_ratio": max(steady_ms) / one_steady_ms,
        "tokens_per_s": b * s / (max(step_ms) / 1e3),
        "peak_gb_per_rank": [r["max_memory_allocated"] / 1e9 for r in train_recs],
        "one_device_peak_gb": one_peak / 1e9, "one_device_s": one_train_s, **held,
        "not_dtensor": not_sharded, "stdout_tail": train_out.splitlines()[-3:],
        "nvidia_smi": smi,
    }
    emit("lm_mesh_10c_train", **train)
    if not (not not_sharded and max(diffs) <= LM_MESH_10C_LOSS_BAND
            and train["losses_equal_across_ranks"] and np.isfinite(train["losses"]).all()):
        raise AssertionError(f"the sharded {arch} trainer failed its checks: {train}")
    emit("lm_mesh_10c_phase", seconds=time.perf_counter() - t_phase, n=n, nvidia_smi=smi)
    return {k: 0 for k in KERNELS}


# The JAX scripts' printed lines that the port's examples must print on the card
# (``JAX_PLATFORMS=cpu PYTHONPATH=src python examples/<name>.py``, jax 0.9.0 on the
# CPU).  Cosine ``predict`` scores in float32 and the packages round differently,
# so the accuracy lines of quickstart and hdc_at_scale are held through their
# labels instead (JAX_EXAMPLE_LABELS).
JAX_EXAMPLE_LINES = {
    "quickstart": [
        "dataset: synth_mnist (synthetic), 784 features, 10 classes",
        "uHD  @ i=1 (one pass):      accuracy = 0.9316",
        "baseline over 3 draws:      avg = 0.9193  (min 0.9043, max 0.9277)",
        "uHD >= baseline average: True",
    ],
    "hdc_at_scale": ["mesh: {'data': 1, 'model': 1}", "Pallas fused kernel         : accuracy 0.9180",
                     "checkpoint round-trip onto mesh: predictions identical = True"],
    "vector_search": [
        "query  label  top-3 classes  hamming distances  margin",
        "  0      5     [5, 4, 7]      [820, 916, 926]      96",
        "  1      7     [7, 8, 5]      [876, 903, 926]      27",
        "  2      2     [2, 6, 1]      [796, 816, 824]      20",
        "  3      7     [7, 5, 4]      [849, 867, 917]      18",
        "  4      6     [6, 3, 0]      [885, 926, 944]      41",
        "  5      7     [7, 5, 6]      [813, 873, 918]      60",
        "  6      7     [7, 3, 5]      [814, 848, 892]      34",
        "  7      2     [2, 3, 0]      [869, 900, 910]      31",
        "",
        "item memory: 5000 rows, 625 KiB packed (1024 dims -> 32 words/row)",
        "self-lookup: [0, 1, 2, 3] at distance [0, 0, 0, 0]",
        "1%-noisy copy of row 7 -> nearest rows [7, 879, 4611] at distances [10, 450, 451]",
        "after deleting rows 0-2, old row 7 is found at position 4",
    ],
    "serve_http": [
        "healthz: ok",
        "model: encoder=uhd d=2048 codebook=1605632 bytes",
        "served accuracy over 64 HTTP requests: 0.9062",
        "watcher promoted step 1: encoder=uhd_dynamic codebook=25088 bytes (same labels: True)",
        "drained and shut down",
    ],
    "online_learning": [
        "base accuracy (256 examples): 0.8281",
        "streamed 2048 feedback examples",
        "learner: trained 2048",
        "accuracy 0.8516, bit-identical to offline partial_fit: True",
    ],
    "scrape_metrics": ["requests=96 ", '  uhd_requests_total{model="mnist"} 96',
                       '  uhd_request_latency_seconds_count{model="mnist"} 96'],
    "fleet_dashboard": ["(0/2 stale, 384 traces merged)", "(0/2 stale, 768 traces merged)",
                        "(0/2 stale, 1152 traces merged)", "(1/2 stale, 1153 traces merged)",
                        "served by target 'pool'", "[STALE] single"],
}
# The JAX package's labels of each model whose cosine accuracy quickstart (uHD, then
# the baseline's three draws) and hdc_at_scale print, image by image: the images
# where JAX's top-2 cosine margin is below 1e-6 (a float32 near-tie, ROADMAP §3), and
# the sha256 of JAX's int32 labels with those images' set to -1.  The port's labels
# on the card, hashed the same way, must give the same digest: they may differ from
# JAX's on a near-tie and nowhere else.  Made with ``JAX_PLATFORMS=cpu
# PYTHONPATH=src:tests python -c "from test_torch_examples_common import *;
# print({n: chip_label_constants(jax_example_labels(n)[1]) for n in EXAMPLE_FITS})"``
# (jax 0.9.0 on the CPU); the example tests hold these constants to that command.
JAX_EXAMPLE_LABELS = {
    "quickstart": [
        {"sha256": "dea9a7ef5f8bd8de49bcf88bc15a7b3d7e8e33105b451303be29278726f21b4f",
         "near_ties": [14, 19, 80, 228, 246, 254, 285, 448, 484]},
        {"sha256": "b85d26551db3b5fa7ef324e71e1d7aabbfb5251344d8367aa7c314b77e4908e6",
         "near_ties": []},
        {"sha256": "224116b705bf02bc786a7e8b45a4ee32de1ffddffbaa7c18f43666a9dfba8f23",
         "near_ties": [284]},
        {"sha256": "f296e02e7b545c10c31d8c6cb9300bdd18eb436bc62388b7ef9e1eacd3974b04",
         "near_ties": []},
    ],
    "hdc_at_scale": [
        {"sha256": "905aba6d8781d41d3fd0a812f3668f0734741fb14e9bfdf465a0c9050a3c4e24",
         "near_ties": [27, 36, 157, 194, 214]},
    ],
}
# the test labels of those models' images: (dataset, test images used); each
# example loads 2,048 training and 512 test images
EXAMPLE_TEST_SET = {"quickstart": ("mnist", 512), "hdc_at_scale": ("synth_mnist", 256)}
# the kernels each example's path must launch on the card (path_launches decides the rest)
EXAMPLE_KERNELS = {
    "quickstart": ("fit_bundle", "encode_bundle", "encode_unary_mxu", "bundle_binarize"),
    "hdc_at_scale": ("fit_bundle", "encode_bundle"),
    "vector_search": ("fit_bundle", "encode_bundle", "hamming_topk"),
    "serve_http": ("fit_bundle", "encode_bundle", "hamming_topk", "encode_bundle_dynamic"),
    "online_learning": ("fit_bundle", "encode_bundle", "hamming_topk"),
    "scrape_metrics": ("fit_bundle", "encode_bundle", "hamming_topk"),
    "fleet_dashboard": ("fit_bundle", "encode_bundle", "hamming_topk"),
    "serve_lm": (),
    "train_lm_e2e": (),
}
# The class sums of ``run_hdc()`` (65,536 synthetic images x 784 features, 16
# classes, D = 8192) from the JAX package's fit on the same images, made on the CPU
# (about 10 s) with: JAX_PLATFORMS=cpu PYTHONPATH=src python -c "import hashlib,
# numpy as np; from repro.core import HDCConfig, HDCModel; rng =
# np.random.default_rng(0); x = rng.integers(0, 256, (65536, 784)).astype(np.float32);
# y = rng.integers(0, 16, 65536).astype(np.int32); m = HDCModel.create(HDCConfig(
# n_features=784, n_classes=16, d=8192)).fit(x, y); print(hashlib.sha256(
# np.asarray(m.class_sums).astype('<i4').tobytes()).hexdigest())"
JAX_DRYRUN_HDC_SHA256 = "682cd90f10f4ded80e6c9f15e40d554d9bcffd91b52f44906b87aac3c0293cfd"


def labels_sha256(labels, near_ties) -> str:
    """sha256 of int32 labels with the near-tie images' labels set to -1."""
    import numpy as np

    masked = np.asarray(labels, dtype="<i4").copy()
    masked[list(near_ties)] = -1
    return hashlib.sha256(masked.tobytes()).hexdigest()


def _check_example(name: str, lines: list[str], labels: list) -> dict:
    """The printed lines of one example against JAX_EXAMPLE_LINES, every
    listed line (or fragment) present as JAX printed it; for quickstart and
    hdc_at_scale, the labels of every ``predict`` call instead of the
    accuracy lines: each model's labels equal JAX's off its near-ties
    (JAX_EXAMPLE_LABELS), and the accuracy printed is that of those labels."""
    import numpy as np

    want = JAX_EXAMPLE_LINES.get(name, [])
    if name not in JAX_EXAMPLE_LABELS:
        return {"missing": [w for w in want if not any(w in x for x in lines)]}
    from repro_torch.data import load_dataset

    dataset, n_test = EXAMPLE_TEST_SET[name]
    truth = load_dataset(dataset, n_train=2048, n_test=512).test_labels[:n_test]
    refs = JAX_EXAMPLE_LABELS[name]
    if name == "hdc_at_scale":  # the fitted model's labels, then the restored checkpoint's
        if len(labels) != 2 or not np.array_equal(labels[0], labels[1]):
            raise AssertionError("hdc_at_scale: the restored model's labels differ")
        labels = labels[:1]
    if len(labels) != len(refs):
        raise AssertionError(f"{name}: {len(labels)} predict calls, {len(refs)} models")
    for i, (got, ref) in enumerate(zip(labels, refs)):
        if labels_sha256(got, ref["near_ties"]) != ref["sha256"]:
            raise AssertionError(f"{name}: model {i}'s labels differ from JAX's off its "
                                 f"near-ties {ref['near_ties']}")
    accs = [float(np.mean(got == truth)) for got in labels]
    if name == "quickstart":
        base = accs[1:]
        printed = [want[0], f"uHD  @ i=1 (one pass):      accuracy = {accs[0]:.4f}",
                   f"baseline over 3 draws:      avg = {sum(base)/len(base):.4f}  "
                   f"(min {min(base):.4f}, max {max(base):.4f})", want[3]]
    else:
        printed = [want[0], f"{'CUDA kernels':28s}: accuracy {accs[0]:.4f}", want[2]]
    return {"accuracies": accs, "near_ties": [len(r["near_ties"]) for r in refs],
            "labels_equal_jax_off_near_ties": True,
            "missing": [x for x in printed if x not in lines]}


@contextlib.contextmanager
def recording_labels(out: list):
    """Append the labels of every ``hdc_model.predict`` call (the function
    every model's ``predict`` and ``evaluate`` reach) to `out`, as numpy."""
    from repro_torch.core import hdc_model

    predict = hdc_model.predict

    def recording(model, images):
        labels = predict(model, images)
        out.append(labels.cpu().numpy())
        return labels

    hdc_model.predict = recording
    try:
        yield
    finally:
        hdc_model.predict = predict


def examples_phase(torch, ops) -> dict[str, dict]:
    """The nine examples of ``repro_torch.examples`` on the card at their own
    sizes (``train_lm_e2e --preset 100m --steps 30``), each a path whose
    launches are counted: its printed lines held against the JAX script's
    (JAX_EXAMPLE_LINES), the LM examples against no HDC kernel; the
    seconds of each."""
    import importlib
    import io
    import shutil

    t_phase = time.perf_counter()
    ckpt = ROOT / "build" / "chip_smoke_lm_e2e"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = {name: ["--device", "cuda"] for name in EXAMPLE_KERNELS}
    argv["train_lm_e2e"] += ["--preset", "100m", "--steps", "30", "--ckpt-dir", str(ckpt)]
    by_path, report, printed = {}, {}, {}
    try:
        for name, kernels in EXAMPLE_KERNELS.items():
            mod = importlib.import_module(f"repro_torch.examples.{name}")
            buf = io.StringIO()

            labels: list = []
            record = (recording_labels(labels) if name in JAX_EXAMPLE_LABELS
                      else contextlib.nullcontext())  # no host read inside a graph capture

            def run(mod=mod, buf=buf, name=name, record=record):
                with contextlib.redirect_stdout(buf), record:
                    return mod.main(argv[name])

            t0 = time.perf_counter()
            absent = () if kernels else tuple(KERNELS)  # the LM examples launch none
            rc, by_path[f"example_{name}"] = path_launches(ops, f"example_{name}", kernels, run,
                                                           absent)
            lines = printed[name] = buf.getvalue().splitlines()
            check = _check_example(name, lines, labels)
            report[name] = {"seconds": time.perf_counter() - t0, "rc": rc, **check}
            emit("example", name=name, seconds=report[name]["seconds"], rc=rc, lines=lines[-24:],
                 **check)
            if rc != 0 or check["missing"]:
                raise AssertionError(f"example {name} failed: rc {rc}, missing {check['missing']}")
        losses = _train_losses("\n".join(printed["train_lm_e2e"]))
        if not (losses and all(v == v for v in losses.values())
                and losses[max(losses)] < losses[min(losses)]):
            raise AssertionError(f"train_lm_e2e --preset 100m: losses {losses}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    emit("examples_phase", seconds=time.perf_counter() - t_phase,
         per_example={k: v["seconds"] for k, v in report.items()})
    return by_path


#: the dry-run's cells on the production mesh over ``meta``
DRYRUN_CELLS = (("qwen3-0.6b", "train_4k"), ("olmoe-1b-7b", "decode_32k"),
                ("recurrentgemma-2b", "train_4k"))


def dryrun_cells_child() -> None:
    """Run in a child process (:func:`start_dryrun_cells`): ``run_cell`` on
    each of DRYRUN_CELLS, one JSON record a line on standard output."""
    from repro_torch.launch import dryrun

    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, do_roofline=True, verbose=False)
        print(json.dumps({
            "arch": arch, "shape": shape,
            "seconds": time.perf_counter() - t0, "run_s": rec["run_s"],
            "flops_global": rec["raw"]["flops_global"], "model_flops": rec["model_flops"],
            "argument_bytes": rec["memory"]["argument_bytes"],
            "peak_bytes_est": rec["memory"]["peak_bytes_est"], "terms": rec["terms"],
            **{k: rec["raw"][k] for k in ("coll_bytes", "coll_by_type", "coll_counts", "coll_s",
                                          "coll_note")},
            "collective_s": rec["terms"]["collective_s"],
        }), flush=True)


def start_dryrun_cells() -> tuple[subprocess.Popen, Path]:
    """The dry-run's cells are host work on ``meta`` (no card): a child
    process computes them while the card's phases run, with the card
    hidden from it; :func:`dryrun_phase` reads them."""
    import os

    d = fresh_dir("dryrun_cells")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}",
               CUDA_VISIBLE_DEVICES="")
    with open(d / "stdout", "w") as out, open(d / "stderr", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.dryrun_cells_child()"],
            env=env, cwd=ROOT, stdout=out, stderr=err)
    return proc, d


def dryrun_phase(torch, ops, smi: str, cells_child: tuple[subprocess.Popen, Path]
                 ) -> dict[str, dict]:
    """``repro_torch.launch.dryrun``: ``run_cell`` on DRYRUN_CELLS of the
    production mesh over ``meta`` (qwen3-0.6b x train_4k, olmoe-1b-7b x
    decode_32k, recurrentgemma-2b x train_4k: seconds, counted flops,
    per-device argument bytes, the roofline terms; each cell's collective
    bytes by kind from its sharded step over the 256-rank ``fake`` group,
    ``collective_s``, and the host seconds the count costs, ``coll_s``),
    computed by `cells_child` (:func:`start_dryrun_cells`) while the earlier
    phases ran, then ``run_hdc()`` at D = 8192 on the card (kernel 3 on
    65,536 x 784 images, 16 classes; launches counted): its fit ms by CUDA
    events, its bound, and its class sums against JAX_DRYRUN_HDC_SHA256."""
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    proc, d = cells_child
    if proc.wait(timeout=900) != 0:
        raise AssertionError(f"the dry-run's cells exited {proc.returncode}: "
                             f"{(d / 'stderr').read_text()[-3000:]}")
    recs = [json.loads(line) for line in (d / "stdout").read_text().splitlines()
            if line.startswith("{")]
    if [(r["arch"], r["shape"]) for r in recs] != list(DRYRUN_CELLS):
        raise AssertionError(f"the dry-run's cells printed {len(recs)} records")
    for rec in recs:
        arch, shape = rec.pop("arch"), rec.pop("shape")
        emit("dryrun_cell", arch=arch, shape=shape, waited_s=time.perf_counter() - t_phase, **rec)
        if not (rec["flops_global"] > 0 and rec["argument_bytes"] > 0):
            raise AssertionError(f"the dry-run of {arch} x {shape} counted nothing")
        if not rec["coll_bytes"] > 0:
            raise AssertionError(f"the dry-run of {arch} x {shape} counted no collective bytes: "
                                 f"{rec['coll_note']}")
    t0 = time.perf_counter()
    rec, launches = path_launches(ops, "dryrun_hdc", ("fit_bundle",),
                                  lambda: dryrun.run_hdc(d=8192, verbose=False),
                                  tuple(k for k in KERNELS if k != "fit_bundle"))
    hdc = {k: rec[k] for k in ("shape", "fit_ms", "fit_ms_all", "timed_by", "bound_ms",
                               "per_device_bytes", "class_sums_sha256")}
    hdc.update(seconds=time.perf_counter() - t0, jax_sha256=JAX_DRYRUN_HDC_SHA256,
               equal=rec["class_sums_sha256"] == JAX_DRYRUN_HDC_SHA256,
               fit_bound_ratio=rec["bound_ms"] / rec["fit_ms"], nvidia_smi=smi)
    emit("dryrun_hdc", **hdc)
    if not hdc["equal"]:
        raise AssertionError("run_hdc's class sums differ from the JAX package's")
    emit("dryrun_phase", seconds=time.perf_counter() - t_phase)
    return {"dryrun_hdc": launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from types import SimpleNamespace

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import (
        HDCConfig, HDCModel, ItemMemory, encoding, partial_fit_sharded, prng, sobol, unary,
    )
    from repro_torch.data import load_dataset
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch import obs_agg, serve_hdc, serve_http, serve_online, train_hdc
    from repro_torch.launch.mesh import mesh_for
    from repro_torch.serving import (
        DeviceExecution, ModelRegistry, ServingEngine, ShardedExecution,
    )

    api = SimpleNamespace(
        CheckpointManager=CheckpointManager, DeviceExecution=DeviceExecution,
        HDCConfig=HDCConfig, HDCModel=HDCModel, ModelRegistry=ModelRegistry,
        ServingEngine=ServingEngine,
        ShardedExecution=ShardedExecution, load_dataset=load_dataset, mesh_for=mesh_for,
        partial_fit_sharded=partial_fit_sharded,
    )

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.library()
    ptxas = [
        line.strip()
        for log in _build.build_info.get("logs", {}).values()
        for line in log.splitlines()
        if "Compiling entry" in line or "registers" in line or "spill" in line
    ]
    sass = sass_counts(_build)
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.build_info["seconds"],
         cached=_build.build_info["cached"], ptxas=ptxas, sass=sass)
    mxu = sass.get("encode_unary_mxu", {})
    if not (mxu.get("IGMMA", 0) > 0 and mxu.get("IMMA", 0) == 0):
        raise AssertionError(f"encode_unary_mxu's SASS is not warpgroup MMA alone: {mxu}")
    if sass.get("hamming_packed", {}).get("BMMA", 0) <= 0:
        raise AssertionError(f"hamming_packed's SASS holds no BMMA: {sass.get('hamming_packed')}")
    launch_floor(torch)

    results = kernel_phase(torch, ops, ref, sobol, unary, encoding, prng)
    by_path = {}
    by_path["slice_uhd_dynamic"], result_dyn = slice_phase(
        torch, ops, serve_hdc, load_dataset, "uhd_dynamic",
        ("encode_bundle_dynamic", "fit_bundle_dynamic", "hamming_topk"),
    )
    by_path["slice_uhd"], result_uhd = slice_phase(
        torch, ops, serve_hdc, load_dataset, "uhd",
        ("encode_bundle", "fit_bundle", "hamming_topk", "encode_bundle_dynamic"),
    )
    dev = torch.device("cuda", torch.cuda.current_device())
    by_path["serve_pool"] = serve_pool_phase(torch, ops, api, result_uhd, dev)
    t_net = time.perf_counter()
    by_path["serve_http"] = serve_http_phase(torch, ops, serve_http, replicas=1)
    by_path["serve_http_pool"] = serve_http_phase(torch, ops, serve_http, replicas=2)
    for encoder in ("uhd", "uhd_dynamic"):
        by_path[f"serve_online_{encoder}"] = serve_online_phase(torch, ops, serve_online, encoder)
    by_path["obs_agg"] = obs_agg_phase(torch, ops, obs_agg)
    emit("network_phases", seconds=time.perf_counter() - t_net,
         phases=["serve_http", "serve_http_pool", "serve_online_uhd", "serve_online_uhd_dynamic",
                 "obs_agg"])
    by_path["train_hdc"] = train_phase(torch, ops, train_hdc, load_dataset)
    by_path["item_memory"], stored = item_memory_phase(torch, ops, ref, ItemMemory)
    sharded_engines = {}
    for encoder, d in [("uhd_dynamic", 8192), ("uhd", 8192), ("uhd_dynamic", 8160),
                       ("uhd", 8160), ("baseline", 8192)]:
        paths, sharded_engines[encoder, d] = sharded_phase(torch, ops, api, encoder, d, dev)
        by_path.update(paths)
    by_path.update(sharded_search_phase(
        torch, ops, api, result_uhd.models[1], result_uhd.probe, stored, dev
    ))
    by_path["train_shard_map"] = train_shard_map_phase(torch, ops, train_hdc)
    cards = [torch.device("cuda", i) for i in range(min(count, 4))]
    by_path["sharded_cards"], cards_engines = sharded_cards_phase(
        torch, ops, api, result_uhd, stored, cards)
    uhd_kernels = ("encode_bundle", "fit_bundle", "encode_bundle_dynamic", "fit_bundle_dynamic",
                   "hamming_packed")
    builds0 = encoding.BASELINE_OPERANDS.builds
    by_path["slice_baseline"], result_base = slice_phase(
        torch, ops, serve_hdc, load_dataset, "baseline", ("encode_unary_mxu", "bundle_binarize", "hamming_topk"),
        uhd_kernels,
    )
    emit("operand_cache", path="slice_baseline", builds=encoding.BASELINE_OPERANDS.builds - builds0)
    by_path["slice_policy"] = policy_phase(torch, ops, api, result_base.models[1], dev)
    by_path["train_baseline"] = train_baseline_phase(torch, ops, train_hdc, load_dataset)
    probe = result_uhd.probe[:64]
    profile_phase(torch, result_dyn.engines[1], probe, "uhd_dynamic")
    profile_phase(torch, result_uhd.engines[1], probe, "uhd")
    profile_phase(torch, sharded_engines["uhd_dynamic", 8192], probe, "uhd_dynamic, 4 shards")
    profile_phase(torch, sharded_engines["uhd", 8192], probe, "uhd, 4 shards")
    profile_phase(torch, result_base.engines[1], probe, "baseline")
    profile_phase(torch, sharded_engines["baseline", 8192], probe, "baseline, 4 shards")
    if len(cards) > 1:  # the same 4-shard engines' work over distinct cards
        for encoder, engine in cards_engines.items():
            profile_phase(torch, engine, probe, f"{encoder}, {len(cards)} cards")

    from repro_torch.configs import get_config

    cells_child = start_dryrun_cells()
    try:
        by_path["lm_serve"] = lm_serve_phase(torch, ops, smi, dev, get_config("qwen3-0.6b"))
        by_path["lm_train"] = lm_train_phase(torch, ops, smi, dev, get_config("qwen3-0.6b"))
        import numpy as np

        by_path["lm_mesh"] = lm_mesh_phase(torch, np, smi, dev, get_config("qwen3-0.6b"))
        by_path["lm_mesh_moe"] = lm_mesh_moe_phase(torch, np, smi, dev)
        by_path["lm_mesh_10c"] = lm_mesh_10c_phase(torch, np, smi, dev)
        by_path.update(examples_phase(torch, ops))
        by_path.update(dryrun_phase(torch, ops, smi, cells_child))
    finally:
        if cells_child[0].poll() is None:
            cells_child[0].kill()
            cells_child[0].wait()

    lost = lost_phase(torch, ops, ref, sobol)
    line = []
    for name, meta in KERNELS.items():
        r = results[name]
        main = json.dumps(MAIN_SHAPE[name], sort_keys=True)
        t = r["timed"][main]
        line.append({
            "name": name, "route": "cuda", "source": meta["source"], "replaces": meta["replaces"],
            "launches": sum(p[name] for p in by_path.values()),
            "launches_by_path": {p: n[name] for p, n in by_path.items() if n[name]},
            "max_abs_err": max(r["max_abs_err"], lost[name]["max_abs_err"]), "ms": t["ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "bound_share": t["bound_share"],
            "library_ms": t.get("library_ms"), "shape": t["shape"], "equal": True,
            "launches_by_kernel_path": by_kernel_path(lost[name]["launches_by_shape"]),
            **{k: t[k] for k in ("bound_ms_direct_form", "bound_ms_pr16", "bound_ms_popc", "op_ms",
                                 "operand_build_ms", "op_first_build_ms", "u_build_ms",
                                 "o_build_ms", "op_device_ms")
               if k in t},
            "launches_by_shape": lost[name]["launches_by_shape"], "lost_ms": lost[name]["lost_ms"],
            "lost_ms_unmeasured_shapes": lost[name]["unmeasured"], "by_shape": lost[name]["shapes"],
            "other_shapes": [{f: x for f, x in v.items() if f != "device_rows"}
                             for k, v in r["timed"].items() if k != main],
        })
        if line[-1]["launches"] <= 0:
            raise AssertionError(f"no path launched the {name} kernel")
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
