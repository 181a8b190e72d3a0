"""On-card smoke test of the PyTorch/CUDA port (`cake_tpu_torch`).

    python3 chip_smoke.py                 # every phase, one H100
    python3 chip_smoke.py --phases kernels,step
    python3 chip_smoke.py --phases device,generate --profile
    python3 chip_smoke.py --phases device,serve --tree DIR  # a parent's serve
    python3 chip_smoke.py --phases device,sp          # sequence parallelism
    python3 chip_smoke.py --phases device,kernels --kernels rpa_decode,flash_attn \
        --tree DIR            # the same cases over the package in DIR

Phases, in order (any failure exits non-zero):
  device    CUDA present; card name and power limit; the three kernel
            libraries built from csrc/ (one nvcc each, in parallel).
  kernels   each CUDA kernel against its plain PyTorch version, f32 and
            bf16 queries: the ragged paged-attention kernels at the serving
            shapes (H=32, KV=8, hd=128, 128-token pages, 16 table columns,
            B=8, C=64) over f32/bf16 pages, over int8 and int4 pages
            written by the port's qwrite_prompt_pages, and over fp8 e4m3
            and e5m2 pages cast by the port's writers (their yardstick
            SDPA over bf16 copies, their bound at one byte an element),
            and the flash pair
            at the prefill shapes (S=T=1024 causal, plus window and
            non-causal cases; a 256-token chunk at pos 1280 of a 4096-slot
            cache with a NaN tail, plus one at an unaligned pos); device
            times from a replayed CUDA graph of 30 calls (the three
            decode kernels' cycling through pool copies larger than L2)
            with the host-launched time beside them, the plain version's
            time, the bound and the yardstick SDPA timed the same way;
            every ragged kernel and the flash pair must give the same
            bits twice; each mixed case logs the body it ran (the
            tensor-core body or rpa_cta) and its split plan.
            More decode cases show the split body: B = 8 with one row
            at pos 8191 (64 table columns) over a bf16, an int8, an int4,
            an fp8 e4m3 and an fp8 e5m2 pool, B = 32 rows up to 2047
            over bf16. Then
            the int4 matmul against its plain version at the four
            Llama-3-8B weight shapes, M = 1, 8 and 64, f32 and bf16 x
            (and f16 over w_gate/w_up, the table's row), weights from
            quantize_group of seeded normals, plus a tiny-config shape:
            one launch counted a product, the same bits twice, the body
            and cluster plan logged; its yardstick is torch.matmul over
            the weight dequantized ahead of time. The kernels line
            carries M = 1 in row 9's numbers and M = 8 and 64 beside
            them ("m8", "m64").
  step      at Llama-3-8B width (2 layers, f32 weights), kernel vs plain:
            mixed_step_paged + decode_step_ragged_paged logits and pools
            over f32, int8 and int4 pools; dense prefill, prefill_chunk
            and decode_step logits and caches with flash on vs off; with
            int4 weights (quantize_params on the card) the dense and the
            paged decode step, kernel vs plain logits, and one prefill
            (M > 64) down the dequantize route. Then at full width and
            depth (the 32-layer random bf16 weights, and later int4
            weights) the engine's decode step as serve/graphs.DecodeRunner
            runs it: K = 4 replays of the captured CUDA graph against the
            same step run 4 times eagerly from identical pools, over a
            bf16, an int8, an int4 and an fp8 e4m3 pool (int4 weights:
            bf16 pool; the bf16 and fp8 replays beside their bounds);
            identical tokens, byte-identical pages, the last step's
            logits' difference (0 expected), 4 x 32 decode launches a
            side, the replay's device ms and the eager step's host ms.
            Then the engine's mixed step as serve/graphs.MixedRunner
            runs it, at the same weights and pools (B = 8, C = 64):
            4 replays of the captured step against the same 4 steps
            run eagerly, with decode rows (one on an unmapped page),
            chunk rows at in-page offsets, a chunk row after two shared
            prefix pages and an idle row; identical tokens, byte-
            identical real pages, the shared pages unchanged, logits
            within GRAPH_TOL, 4 x 32 mixed-attention launches a side
            (and no int4_matmul: the block products have 512 rows, the
            lm_head is int8), a replay's device ms beside the step's
            bound, and each pool's window writer's device ms a layer.
  generate  32-layer Llama-3-8B-width bf16 weights (random), sequential
            generator behind Master.generate_text: a ~1000-token prompt
            (bucket 1024, one flash_attn launch per layer) and a
            ~1500-token prompt in 256-token windows (six flash_attn_cached
            launches per layer), 32 greedy tokens each (run A's device
            busy share under --profile); the generator's captured decode
            step: 8 replays against 8 eager steps from identical caches
            (identical tokens and logits, replay device ms beside the
            eager step's host ms); generate_on_device at B = 1 and 4
            against next_token's greedy stream (flash off); then a
            small checkpoint directory written here (config.json, a
            hand-written model.safetensors of random f32 weights, a
            byte-level BPE tokenizer.json: 256 byte tokens, 300 merges
            learned from this docstring, Llama-3's special tokens and
            split) read through the port's reader (a mixed-script round
            trip printed and required) and served by `python3 -m
            cake_tpu_torch.cli --model DIR --batch-size 2 --tracing DIR`
            on the card (exit 0, exactly one trace file). Then 32-layer
            int4 weights (init_params_quantized, bits=4) behind the same
            Master: 32 greedy tokens, 7 x 32 int4_matmul launches per
            decode step and no plain call; a few tokens with int8
            weights; and the command line with --quant int4. The two
            command lines run in their own processes while dense (a)'s
            identity drives run (untimed; the time budget).
  serve     the same weights behind the HTTP API: six concurrent chat
            requests (three SSE) of 32 tokens through the paged engine,
            over a bf16 pool at --decode-scan 1 and 4, then int8 and int4
            pools at 4 (these four at the first CUT_LAYERS blocks since
            PR 24, the smoke's time budget), then the 32-layer int4
            weights over a bf16 pool at 4. Each
            configuration drives the chats through one engine (cold,
            warm, and over the bf16 pool warm under torch.profiler)
            and prints
            decode tok/s, TTFT p50, the served wall and (profiled) the
            device's busy share; its kernels must have run (replays of
            the captured decode and mixed steps counted) and no plain
            version; int4
            weights: 7 int4_matmul launches per rpa_decode launch. A
            tree without the captured step (--tree of a parent) serves
            at --decode-scan 1 only. A `serve` JSON line holds the
            drives' records.
  prefix    shared-prefix pages and the phase-split prefill at the same
            width (the first CUT_LAYERS blocks since PR 24, the smoke's
            time budget), over a bf16 and an int8 pool: the prefix's
            prefill into its 5 pages, a suffix after it and a window of a
            row that maps it, each with attn="kernel" (flash_attn,
            flash_attn_cached: a launch a layer a call) and attn="plain" from
            one pool (layer 0's pages identical, logits and pages within
            PREFIX_REL_TOL of their magnitude); each captured one-slot
            prefill (serve/graphs.PrefillRunner: a 256 bucket, a
            128-token suffix after the prefix, a 64-token chunk at the
            unaligned pos 677) against its eager call from one pool:
            byte-identical pages, equal logits, replay device ms beside
            the eager host ms; then a warm-up chat and six
            concurrent chats with one ~700-token system message through
            the HTTP API with --auto-prefix at --mixed-batch auto and off
            (--decode-scan 4), and the same chats without it: 6 prefix
            hits a drive, fewer pages in use at peak than without, the
            shared pages' bytes and scales unchanged, only the registry's
            pages live at the end, flash launches on the served path and
            no plain version; TTFT p50, decode tok/s and wall beside the
            card's name and power limit. A `prefix` JSON line holds the
            drives' records.
  sched     SLO scheduling and the observability core at the same width
            and depth (bf16 weights, a 40-page bf16 pool, 8 slots, chunk
            64, --decode-scan 4) through the HTTP API with
            --priority-classes: round A, six batch chats of 512 + 256
            tokens (6 pages each), then two interactive chats of 300 +
            64 (3 pages), the second page-starved: exactly one "pages"
            preemption; round B, eight batch chats of 128 + 64 fill the
            slots, one interactive chat: exactly one "slots" preemption
            (both read from /metrics). Every chat completes and the free
            pages return to 40. The same arrivals without the classes
            (the FIFO drive) give the interactive TTFT p50 beside the
            classes' (printed). /api/v1/steps: every record's mfu in
            (0, 1], its unclamped ratios at most 1.05, means per kind,
            and the decode records' hbm_util within 30% of the step
            phase's decode bound over its replay (same call). Each
            preempted stream against the FIFO drive's: printed at bf16,
            required token-identical at f32 (the same rounds at 8B
            width, 4 layers, f32 weights and pool). Then a burst of 48
            batch chats past the shed's depth (--shed, batch held to a
            1 s queue-wait target): some get 429 with a Retry-After
            above 0. A `sched` JSON line holds the phase's record.
  tiers     the KV tiers at the same width, the bf16 weights' first
            CUT_LAYERS = 8 blocks (the time budget), through the HTTP
            API: (1) six chats over a bf16, an fp8 e4m3 and an fp8 e5m2
            pool at --decode-scan 4, cold then warm: TTFT p50, decode
            tok/s and pool GiB beside the bf16 drive's, the fp8 kernels'
            launches (the kernels line's fp8 rows) and no plain version;
            the tier's spill and restore ms a page of the bf16 and e4m3
            pools (8 pages a move, CUDA events); (2) the sched phase's
            round A with --kv-host-pages and the resident spill off:
            exactly one "pages" preemption, one spill and one restore of
            the victim's pages (cake_kv_spill_total{dir}), the restored
            pages byte-identical to the spilled ones, the victim against
            the FIFO drive printed; (3) the same at 4 layers and f32,
            where the victim must be token-identical; (4) a 14-page pool
            with --auto-prefix: a chat registers a 5-page system head,
            eight 3-page chats arrive at once (the cold prefix spills,
            decode-resident streams park and come back), every chat
            completes, cake_kv_resident_spills_total rises, and a last
            chat with the head restores the prefix and hits it; every
            page comes back. A `tiers` JSON line holds the record.
  recovery  fault injection and crash recovery at Llama-3-8B width, through
            the HTTP API: (1) the bf16 weights' first CUT_LAYERS = 8
            blocks (the time budget), the serve
            phase's 128 x 128 pool, 8 slots, --decode-scan 4, six chats
            of 64 tokens at once, without a plan (cold and warm waves),
            with a never-firing plan at every site (cold, then the warm
            wave with every site test, decode dispatch, mixed replay,
            admission and page allocation under
            torch.cuda.set_sync_debug_mode("error")), and, after a warm
            wave with the plan disarmed, with RECOVERY_PLAN (a mixed
            dispatch, a burst's entry, the top of an iteration) plus a
            fetch that fails inside a burst chain with the next burst in
            flight: every chat 200, recoveries = the faults that fired,
            none quarantined, no graph captured anew and
            cake_jit_compiles_total unchanged across the wave (the
            in-place reset), then RECOVERY_FALLBACK with the in-place
            reset forced to raise (the rebuild); each reset's
            torch.cuda.max_memory_allocated at most a tenth of a pool
            above what it held before; recovery seconds, TTFT p50 and
            decode tok/s beside the warm wave without a plan;
            (2) 2 layers, f32 weights and pool: the plan's greedy streams
            equal the run's without it at decode_scan 4 (1 cut for the
            time budget); (3) a
            poison prefill (engine.prefill:match_len) quarantines exactly
            its chat (500), the others 200; POST /api/v1/drain: a late
            chat gets 429 with Retry-After, the in-flight ones 200; the
            storm breaker stops the engine with a snapshot of every
            request, restored token-identically; (4) a child process
            serving with --journal dies by engine.decode:nth=10:abort
            (exit 86) under three keyed SSE streams, a second child
            replays the journal, each client's Last-Event-ID gets exactly
            its suffix, and the journaled streams equal an uninterrupted
            run's; (5) a child process trips a device-side assert before
            a decode dispatch: its in-place reset and its rebuild raise,
            it stops with reset_failed (health "stopped", every client a
            retryable error, the snapshot written without a device read),
            and this process resumes the snapshot to the uninterrupted
            f32 streams. (4)'s and (5)'s children run while (2) and (3)
            run (untimed: (2) keeps no recovery seconds; the time
            budget). A `recovery` JSON line holds the record.
  spec      paged speculative decoding and the batch-1 draft generator:
            the bodies the spec path launches held against their plain
            versions at its shapes (the mixed body and its merge at
            verify windows C = 2 and 5, the window writer's targets at
            the same C against a scatter, the split decode body and
            flash at the 1B draft's hd = 64, int4_matmul at 40 rows);
            (a) 8B width, 2 layers, f32 weights and pool: the card's
            spec engine (self-draft, a mismatched 1-layer draft, gamma
            3) token-identical to the card's plain engine and the CPU's
            spec engine, the pool conserved after every wave; a
            spec.verify:always storm degrades every stream (spec_degraded)
            and each finishes exactly; across an in-place recovery the
            round captures nothing anew; SpeculativeGenerator equal to
            greedy LlamaGenerator, and one spec_scan of 4 chained
            replays equal to four single rounds. (b) the phases' bf16
            weights cut to their first CUT_LAYERS = 8 blocks (the time
            budget), 128 x 128-token pages, 8 slots, six
            chats of 64 tokens at repeat_penalty 1.0, gamma 4, after a
            warm-up wave: the plain engine, then drafts self and a
            Llama-3.2-1B-shaped random draft cut to 2 of its 16 layers
            (the target's first 4 blocks as a draft cut for the time
            budget) (D 2048, hd 64, tied
            embeddings: the draft pool at hd 64 and its captured
            rounds): tok/s, acceptance, tokens a round, a round's device
            ms beside its bound, captures (none allowed in the measured
            wave), degrade and shrink events, pool GiB; the self-draft
            over int4 weights (int4_matmul launched by the verify);
            the generator with a self-draft at 4096 slots, R = 4, beside
            the plain generator. Acceptance is printed, not gated
            (random weights decide it). A `spec` JSON line holds the
            record; each kernel row carries `spec_launches`, its
            launches in the measured self-draft wave.
  control   live reconfiguration and the engine's control plane of obs/:
            (1)-(4) run the phases' bf16 weights cut to their first
            CUT_LAYERS = 8 blocks (the time budget), but (4)'s
            shed storm, which needs the full depth's service rate.
            (1) those weights behind the HTTP API at 8 slots,
            --decode-scan 1, a 128 x 128-token bf16 pool, with --autotune
            manual, --sentinel (interval 0.5 s), --sentinel-act,
            --profile-dir and --postmortem-dir: a cold and a warm wave of
            six chats of 64 tokens, then, inside a wave once every chat
            has its first token, a POST to 16 slots, --decode-scan 4 and
            256 pages, a warm wave, a POST to the same over int8 pages,
            a warm wave; inside the next wave the int8 -> bf16 switch
            (400, JAX's reason), a pool the in-flight streams do not fit
            (400), and a switch to 8 slots with --mixed-batch off met by
            a concurrent POST (409); a warm wave there; a profile capture
            inside a wave of 96-token chats (its trace must name the
            port's kernels; a concurrent capture 409; --profile-dir warms
            the profiler at the server's start); then a 65536-page int8
            pool the card cannot hold (400 naming the OOM, the previous
            config serving). Every chat
            200; each switch's seconds, streams carried, allocated bytes
            before, peak and after (the peak at most a tenth of the
            larger pool above the larger of before and after) and
            reserved bytes; no capture in a warm wave after a switch;
            each config's TTFT p50 and decode tok/s; the int8 bodies
            launched after the int8 switch, the flash pair after the
            --mixed-batch off one, no plain version; a folded chat's
            timeline (its reconfigured entry, its step records) and a
            404; /api/v1/anomalies and the action history printed.
            (2) 8B width, 2 layers, f32 weights and pool: greedy streams
            crossing seven mid-stream switches (slots 8 -> 4 -> 8,
            decode_scan 1 -> 4, pages 128 -> 64, page size 128 -> 64,
            mixed batching on -> off -> on) equal the uninterrupted run's
            and the CPU engine's, the pool conserved; a warm drive at the
            last config captures nothing, nor does an in-place recovery.
            (3) the port's fitter (python -m
            cake_tpu_torch.tools.autotune_fit) over (1)'s step logs
            writes a policy that validates; an --autotune auto engine at
            full width over a two-regime policy and a fast controller
            (interval 0.5 s, window 2, hold 1, cooldown 2 s) takes
            exactly one policy switch across a low-rate wave and a burst,
            every chat 200, its decision log printed (its rollback
            verdict held past the drive). (4) the sched phase's 48-chat
            shed burst, four times half a second apart, with --sentinel:
            shed_storm fires and clears; a storm-breaker stop with
            --postmortem-dir and
            --journal writes exactly one bundle with the steps, events,
            traces, anomalies, actions, stats, metrics and journal_tail
            keys. A `control` JSON line holds the record; each kernel row
            carries `control_launches`, its launches in (1)'s waves after
            the cold one.
  disagg    disaggregated prefill/decode (kv/transfer.py): a prefill
            engine and a decode engine in this process, sharing one
            parameter object, over a loopback page channel. (a) 8B
            width, 2 layers, f32 weights and pool, 16-token pages, 8
            slots: six greedy chats of 16 tokens sharing a 32-token head
            through the pair, against one colocated card engine (with
            and without the head registered) and the CPU engine (with
            it), in six waves: plain; the head registered on both hosts;
            a kv.ship fault on the prefill host; a kv.adopt fault on the
            decode host; a reconfigure of the decode host while the
            shipments are held (each refused with outcome "epoch");
            no prefill peer (the prefill host stopped). Identical
            streams, both allocators back to their pages after each
            wave, each outcome counted in cake_kv_adopt_total. (b) the
            phases' bf16 weights cut to their first CUT_LAYERS = 8
            blocks (the time budget), 128 x 128-token pages and
            8 slots on each host, the decode host behind the HTTP API,
            --decode-scan 4, chunk 256: six chats of 1000-token prompts
            (8 pages) and 64 tokens, a warm-up wave then a measured one,
            on the colocated engine, the pair, and the pair over int8
            pages: TTFT p50, decode tok/s, shipments and the bytes a
            shipment (equal to the count by hand: 33554432 over bf16,
            16781312 over int8, at CUT_LAYERS = 8), cake_kv_ship_seconds
            p50 and its GB/s,
            the prefill host's TTFT p50 and the channel's share of the
            TTFT, the kernels launched (rpa_mixed on the prefill host,
            rpa_decode on the decode host, the q8 bodies over int8; the
            decode host runs decode steps only, the prefill host no
            decode step), no plain version, no capture in a warm wave,
            every chat adopted; GET /api/v1/fleet answers for one host.
            A `disagg` JSON line holds the record; each kernel row
            carries `disagg_launches`, its launches in (b)'s measured
            pair waves.
  dense     the dense-cache engine, the ring engine and the dense spec
            engine (ROADMAP A11). (a) 8B width, 2 layers, a 512-token
            vocabulary, f32 weights and cache: a whole-prompt
            prefill_slot and a chunk window of prefill_slot_chunk at
            pos0 173, each replayed from its captured graph
            (serve/graphs.DensePrefillRunner), against the same step on
            the host, where flash_attn and flash_attn_cached run their
            plain versions (one launch a layer a replay); then greedy
            streams of card engines against the CPU engine's (flash off
            there, run on a thread meanwhile): the dense engine with
            whole-prompt prefills and two prefix hits at --decode-scan 4
            (1 cut for the time budget), with --prefill-chunk 32
            (windows, an install and hits) at 4; the ring engine (a
            32-slot window, max_seq_len 128, prompts of 40 and 70
            tokens, 40 new tokens); the dense
            spec engine with a self-draft and a mismatched 1-layer draft
            (gamma 3); a paged engine switched to the dense engine and
            back under load; a warm wave of the chunked, ring and
            self-draft engines capturing nothing, no plain version on
            the card. (b)-(d) run the bf16 weights' first CUT_LAYERS =
            8 blocks (the time budget). (b) those weights behind the HTTP API:
            the dense engine Master.make_engine builds with --kv-pages
            unset (8 slots at max_seq_len 4096, a 4 GiB cache) and
            --auto-prefix, and the paged engine (128 x 128-token pages)
            on the same waves: six ~1000-token chats of 64 new tokens
            (three share a 400-token system message: prefix hits), a
            warm-up wave then a measured one: TTFT p50, decode tok/s,
            the decode replay's device ms, the flash launches (both
            kernels required) and no plain version, no capture; then the
            largest prefill_slot bucket and prefill_slot_prefixed key
            that wave replayed, each captured over a random bf16 cache
            of (b)'s shape and held against the same step with flash off
            on the same inputs (logits and the slot's lines within
            PREFIX_REL_TOL of their magnitude, layer 1's lines within
            L1_REL_TOL of theirs, layer 0 and the prefix identical, the
            other slots untouched).
            (c) the same weights with sliding_window 4096 (Mistral-7B's)
            at max_seq_len 8192: the ring engine, two chats of
            5000-token prompts and 64 new tokens after a warm-up: TTFT,
            tok/s, the ring's bytes a slot beside a dense row's. (d) the
            dense spec engine at 8 slots and max_seq_len 4096, the
            target's first 4 blocks as the draft, gamma 4, (b)'s
            prompts: acceptance, tokens a round, tok/s beside (b)'s
            dense engine (printed, not gated). A `dense` JSON line holds
            the record; each kernel row carries `dense_launches`, its
            launches in (b)'s measured dense wave.
  moe       Mixtral's mixture-of-experts (ROADMAP A12). (a) the tiny MoE
            (2 layers, 4 experts, top 2) at f32, its weights drawn on the
            host from a seed: the paged engine at --mixed-batch auto and
            off and --decode-scan 1 and 4, the dense engine, the ring
            engine (a 16-slot window, prompts past it), a paged
            self-draft spec engine, each on the card against the same
            flavor on the CPU over two waves (equal greedy streams; the
            warm wave captures nothing), and the generator's replayed
            decode steps against the CPU generator's. (b) Mixtral-8x7B
            width (D 4096, F 14336, H 32, KV 8, hd 128, E 8, top 2,
            V 32000) at MOE_LAYERS = 4 of its 32 layers, random weights:
            the paged engine (8 slots, 128 x 128-token pages) behind
            the HTTP API, six chats of 64 tokens, two warm-up waves
            (more, to MOE_WARM_MAX, until one captures nothing) then a
            measured one, in three drives (MOE_DRIVES): bf16 (mixed
            steps: rpa_decode, rpa_mixed), the int8 tree over int8 pages
            (--quant int8 --kv-dtype int8: rpa_decode_q8, rpa_mixed_q8)
            and bf16 at --mixed-batch off with --prefill-chunk 256 (the
            short prompts' whole-prompt flash prefills, the long ones'
            windows: rpa_decode, flash_attn, flash_attn_cached); each
            measured wave must launch its kernels, no plain version and
            no capture. TTFT p50, decode tok/s, a decode replay's device
            ms beside its bound (every expert's bytes, the lm_head's and
            the KV history's over the memory rate: the dense formulation
            reads all experts), weight GiB, launches. A `moe` JSON line
            holds the record; each kernel row carries `moe_launches`,
            its launches summed over (b)'s three measured waves.
  sd        Stable Diffusion (ROADMAP A14). (a) tiny_sd_config at f32,
            the trees drawn on the host: the card generator's u8 images
            within one level of the CPU generator's (the noise drawn on
            the host for both), and the captured UNet step within
            SD_REL_TOL of its eager call, guidance on and off, one
            capture a variant. (b) v1-5 at 512 x 512, bf16, random
            weights through Master.from_args: txt2img through POST
            /api/v1/image, 20 DDIM steps at guidance 7.5 (the UNet's
            batch 2), a valid 512 x 512 PNG, one capture, the memory
            peak over it; the UNet step's replay device ms beside its
            eager host ms and its bound (FLOPs counted from the config,
            `unet_flops`, at the bf16 peak); then
            `python -m cake_tpu_torch.cli --model-type image --sd-img2img
            <that PNG> --sd-img2img-strength 0.8 --sd-n-steps 4` in a
            child process writes a 512 x 512 image_0.png. (c) turbo
            (SDXL width: two encoders, Euler, the added condition) at
            512 x 512, bf16: one step, no guidance, and its UNet step's
            times. An `sd` JSON line holds the record.
  parallel  topology-sharded serving (ROADMAP A13 part 1) on a mesh
            whose positions repeat the card (what sharding costs, not a
            speed-up): (a) 8 of Llama-3-8B's 32 blocks at f32 over a
            4 + 4 topology with --tp 2 --microbatches 2, eight chats
            through Master.make_engine behind the HTTP API, the streams
            equal to the unsharded dense engine's on the same wave, the
            measured wave's flash launches (whole prompts and chunk
            windows) from the sharded steps, no capture; TTFT p50,
            decode tok/s and a decode replay's device ms of both; then
            one prefill and one decode step at bf16 through the
            pipelined steps within PAR_BF16_TOL of max |logits|; rows
            7-9 at the tp shard shapes against their plain versions
            (flash at f32, as (a) runs them, and at bf16), the int4
            cluster plans; (b) the generator through
            Context.load_text_model over stage 2 x dp 2 at batch 4,
            greedy-identical to unsharded, and --quant int4 over stage
            2 x tp 2 (its int4_matmul launches, no plain one); (c)
            Mixtral width, 2 blocks, over tp 2, greedy-identical, and
            SD v1-5 --dp 2 at f32 within PAR_SD_LEVELS of the unsharded
            image; at bf16 (the same weights rounded) the dp mesh's UNet
            call equal to two batch-1 calls with no mesh, and the --dp 2
            image no farther from the f32 image than PAR_SD_BF16_RATIO
            times the unsharded bf16 image is. A `parallel` JSON line holds the record; each kernel
            row carries `parallel_launches`.
  sp        sequence parallelism (ROADMAP A13 part 1b) on meshes whose
            positions repeat the card (what sp costs on one card, not a
            speed-up): (a) 8 of Llama-3-8B's blocks at f32, --sp 4
            --max-seq-len 4112 --sample-len 16 (a 4096-token context
            and a 16-token tail), 4 slots, four chats of 1000 to 4000
            prompt tokens and 16 new tokens through Master.make_engine
            behind the HTTP API, both engines at --decode-scan 4: the
            streams equal to the unsharded dense engine's on the same
            wave, the sp steps replayed graphs (one prefill capture for
            the window), the measured wave capturing nothing, TTFT p50,
            decode tok/s and a decode replay's device ms of both; then
            the sp engine's captured decode step, one 4-step burst
            against four single steps; (b) the generator through
            Context.load_text_model over sp 2 x tp 2 on a full
            4096-token prompt greedy-identical to unsharded, and
            --quant int4 over sp 2 x tp 2: its int4_matmul launches (no
            plain one), its prefill logits within PAR_BF16_TOL of max
            against the unsharded int4 generator's, and each block
            product at the tp shard shapes against its plain version;
            (c) stage 2 x sp 2 (4 + 4) and
            dp 2 x sp 2 engines greedy-identical to the unsharded
            engine on two full-window and two short prompts, and one
            bf16 prefill and decode step through the sp 4 steps within
            PAR_BF16_TOL of max |logits|. An `sp` JSON line holds the
            record; each kernel row carries `sp_launches`.
  multihost multi-process serving (ROADMAP A13 part 2): two processes on
            the card, each `python -m cake_tpu_torch.cli` (through
            cli.main) with CAKE_COORDINATOR / CAKE_NUM_PROCESSES /
            CAKE_PROCESS_ID, the coordinator on process 0, hops over gloo
            (the backend rule: two ranks share the card); 8 of
            Llama-3-8B's blocks drawn in each process from seed 0 (its
            lm_head cut to printable ASCII: no EOS), a 4 + 4 topology, one
            stage a process, --max-slots 4 --decode-scan 4 --auto-prefix
            --checkpoint; one HTTP client against process 0. (a) f32:
            four chats sharing a system prompt, buffered, then streamed
            twice over SSE, then a second conversation sharing the
            prompt: every text the single-process unsharded dense
            engine's on the same weights; prefix hits and one replayed
            register_prefix; /api/v1/cluster (2 processes, the backend);
            proc1's lag 0 in /api/v1/fleet; the last SSE wave captures
            nothing on either process (cake_jit_compiles_total, local and
            proc1's federated). (c) the follower is killed (SIGKILL) in
            the middle of a long stream: within --heartbeat-timeout
            /api/v1/health reads failed naming proc1, a new chat gets a
            503, the pre-fail checkpoint holds the request unfinished,
            its tokens the reference's so far. (b) bf16: eight SSE chats
            (a warm wave, then the measured one) on a fresh pair, the
            single-process co-located 4 + 4 engine and the unsharded
            engine: TTFT p50, decode tok/s, cake_control_publish_seconds
            p50, each process's host seconds a hop and graphs (replays)
            a decode step; before (b), a --quant int4 pair's wave, whose
            int4_matmul launches (both processes) hold row 9. (d) each
            fresh pair's coordinator gets SIGTERM: the follower exits 0,
            the coordinator 0 or -15, the checkpoint is on disk. Rows 7-9
            at the stage's shard shapes against their plain versions.
            (e) ROADMAP A13 part 3: `--sp 2` across the two processes
            (one sp position each, no topology, --max-seq-len 2064: a
            2048-token context), the same 8 blocks: two full-window
            chats and two short ones; at f32 a warm SSE wave then a
            measured one whose texts must be the single-process
            co-located --sp 2 engine's and the unsharded engine's and
            which captures nothing on either process; at bf16 the pair's
            measured wave beside the co-located sp 2 engine's: TTFT p50,
            decode tok/s, each process's hops, a hop's host ms and the
            graphs a decode step is cut into. (f) SD v1-5 at 512 x 512,
            bf16 random weights, over two processes (`--model-type image
            --api`, one dp position each): 20 DDIM steps at guidance 7.5
            through POST /api/v1/image on process 0, twice, the follower
            replaying; the PNG within one u8 level of the single-process
            co-located --dp 2 generator's (the same seed); seconds an
            image beside it; img2img refused with JAX's message; the
            follower exits 0 on SIGTERM. The pairs start while only
            untimed drives run: (a)-(d)'s at the phase's start, (e)'s
            f32 pair and (f)'s after (c), (e)'s bf16 pair during (d);
            every pair is up, and idles, before a timed wave: (b) after
            (e)'s f32 identities, then (e) bf16 and (f). A `multihost`
            JSON line holds
            the record; each kernel row carries `multihost_launches`
            (the pairs' processes' counts; (e) and (f) launch none of
            the port's kernels: the sp ring and SD are einsums).
  router    the front-door router (ROADMAP A15): `python -m
            cake_tpu_torch.cli --router` (its --model a directory whose
            byte-level BPE tokenizer.json this script writes) over two
            replica processes (`cli.main --api`, the paged engine,
            --auto-prefix, 256 x 128-token pages, 8 slots,
            --decode-scan 4, Llama-3-8B width from seed 0, the lm_head
            cut to printable ASCII), one named by --replicas, the other
            registered by --router-announce. (a) f32 at 2 blocks: three
            tenants' system prompts of 256-600 tokens, four SSE chats
            each: every text through the router is the named replica's
            own (x-cake-replica), a tenant's chats on one replica. (c)
            kill: a keyed stream's home SIGKILLed after its first
            events; the reconnect with the key and Last-Event-ID
            finishes on the survivor with the reference's text, and the
            router's federated timeline names both replicas. (b) bf16
            at 8 blocks (both replicas announce, one also named): twelve
            SSE chats of 16 tokens, a warm wave then a measured one,
            then the same chats straight to their replicas: TTFT p50
            both ways, prefix hits per replica, the cake_router_*
            families, /api/v1/fleet with both replicas, no capture in
            the measured wave, rpa_decode and rpa_mixed launched there
            (the replicas' counts zeroed by SIGUSR1 just before, read by
            SIGUSR2 just after) and no plain version. (c) drain: a
            stream's home drains; the router's state is awaited until it
            stops admitting there; three new chats go to the other, the
            stream finishes. (d) the other replica SIGTERMed: the
            router's replica_departed precedes the process's exit. A
            `router` JSON line holds the record; each kernel row carries
            `router_launches` (the measured wave's).
  native    the host runtime (ROADMAP A16). Right after device: (a)
            libcake_native (csrc/scheduler.cpp, csrc/safetensors.cpp)
            and libcake_embed (csrc/embed.cpp against libpython) built
            with g++ into _build/, each build's seconds; the smoke fails
            if the native library does not load (the Python fallbacks
            would hide it). (b) NativeScheduler against PyScheduler over
            one seeded sequence of NATIVE_OPS submits, duplicates,
            cancels, plans and reports: the same plans and counters, and
            microseconds a plan() each. After every other phase: (d) the
            serve phase's engines and every _SchedServer without classes
            (the sched FIFO drive among them) ran NativeScheduler; the
            generate phase's checkpoint command line read through the
            native reader (its log line); (e) a C host built from
            examples/embed_host/main.c against libcake_embed generates 8
            tokens from that checkpoint in a fresh process; (f) `python
            -m cake_tpu_torch.tools.cakelint cake_tpu_torch/ --json`
            exits 0 with sites in all four rules, and `python -m
            cake_tpu_torch.tools.journal_check` reads the recovery
            phase's journal (rc 0). Meanwhile a thread writes a 2-layer
            Llama-3-8B-width bf16 checkpoint (~2.9 GB); then (c) it
            loads through load_params_from_hf with the native reader and
            with the numpy memmap (page cache warm for both), equal
            tensors on the card, both load times. A `native` JSON line
            holds the record. The whole smoke runs with
            CAKE_THREAD_ASSERTS=1 (set before the port is imported, so
            every child inherits it): a WrongThreadError in this process
            (analysis.annotations.VIOLATIONS) or in a child's log fails
            the run.

The line before last is a JSON `kernels` record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX or `cake_tpu`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import weakref
from collections import Counter

PHASES = ("device", "native", "kernels", "step", "generate", "serve",
          "prefix", "sched", "tiers", "recovery", "spec", "control",
          "disagg", "dense", "moe", "sd", "parallel", "sp", "multihost",
          "router")
# the depth the serve phase's pool runs, the prefix, tiers, recovery and
# spec phases, the control phase's (1) and (3), the disagg phase's (b)
# and the dense phase's (b)-(d) run the Llama-3-8B-width bf16 weights
# at: their first blocks of the 32 (the smoke's time budget)
CUT_LAYERS = 8
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12,    # FMA-pipe f32; TC
            "float16": 989e12}
# kernel -> (its source, the TPU kernel it replaces)
KERNELS = {
    "rpa_decode": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                   "cake_tpu/ops/ragged_paged_attention.py:65"),
    "rpa_mixed": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                  "cake_tpu/ops/ragged_paged_attention.py:391"),
    "rpa_decode_q8": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                      "cake_tpu/ops/ragged_paged_attention.py:141"),
    "rpa_mixed_q8": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                     "cake_tpu/ops/ragged_paged_attention.py:479"),
    "rpa_decode_q4": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                      "cake_tpu/ops/ragged_paged_attention.py:223"),
    "rpa_mixed_q4": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                     "cake_tpu/ops/ragged_paged_attention.py:557"),
    # fp8 pages run JAX's _rpa_kernel / _rpa_mixed_kernel bodies, as bf16
    # pages do (cake_tpu/models/llama/paged.py:382, :474)
    "rpa_decode_f8e4m3": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                          "cake_tpu/ops/ragged_paged_attention.py:65"),
    "rpa_mixed_f8e4m3": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                         "cake_tpu/ops/ragged_paged_attention.py:391"),
    "rpa_decode_f8e5m2": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                          "cake_tpu/ops/ragged_paged_attention.py:65"),
    "rpa_mixed_f8e5m2": ("cake_tpu_torch/csrc/ragged_paged_attention.cu",
                         "cake_tpu/ops/ragged_paged_attention.py:391"),
    "flash_attn": ("cake_tpu_torch/csrc/flash_attention.cu",
                   "cake_tpu/ops/flash_attention.py:74"),
    "flash_attn_cached": ("cake_tpu_torch/csrc/flash_attention.cu",
                          "cake_tpu/ops/flash_attention.py:125"),
    "int4_matmul": ("cake_tpu_torch/csrc/int4_matmul.cu",
                    "cake_tpu/ops/int4_matmul.py:73"),
}
# the --kv-dtype names of the fp8 pools and their torch dtypes' names
FP8_FORMATS = {"f8_e4m3": "float8_e4m3fn", "f8_e5m2": "float8_e5m2"}
TOL = {"float32": dict(atol=1e-4, rtol=0.0),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


# -- phase: device ------------------------------------------------------------


def phase_device(torch, *ops) -> str:
    from cake_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout else "unknown"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    sources = [op.SOURCE for op in ops]
    cuda_build.build_libraries(sources)                   # nvcc in parallel
    for op in ops:
        op.LIBRARY.get()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s for the "
        f"{len(ops)} libraries")
    for src in sources:
        info = cuda_build.BUILD_INFO.get(src, {})
        log(f"  {os.path.basename(src)}: nvcc {info.get('seconds', 0.0):.2f} s")
        entry = ""
        for line in info.get("ptxas", "").splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line:
                log(f"    ptxas: {entry}: {line.split(':', 1)[-1].strip()}")
    return card


# -- phase: kernels -----------------------------------------------------------


def _time_ms(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn() after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _kernel_case(torch, dtype, gen, mixed: bool, fmt=None):
    """Serving-shape inputs: ragged positions, page boundaries, an
    unmapped hole, a dead row; for the mixed kernel decode rows, chunk
    rows at odd page offsets and an idle (q_len = 0) row. Pages are in
    q's dtype, or with fmt "int8"/"int4" written from a normal draw by
    the port's qwrite_prompt_pages (the kernel's scale arguments go in
    the returned kwargs)."""
    dev = "cuda"
    B, H, KV, hd, P, MP, N = 8, 32, 8, 128, 128, 16, 128
    C = 64 if mixed else 1
    pool_k, pool_v, kw = _pools(torch, gen, fmt, dtype, N, P, KV, hd)
    q = torch.randn((B, C, H, hd), generator=gen, device=dev, dtype=dtype)
    perm = torch.randperm(N, generator=gen, device=dev).to(torch.int32)
    table = perm.reshape(B, MP).clone()
    if mixed:
        pos = [2047, 127, 5 * P + 77, 3 * P + 100, 0, 9 * P + 127,
               1000, 400]
        q_len = [1, 64, 64, 0, 1, 37, 1, 64]
    else:
        pos = [0, 127, 128, 2 * P + 5, 1000, 2047, 4 * P, 300]
        q_len = None
    table[3, 1] = -1                  # unmapped hole inside the live range
    table[7 if not mixed else 4] = -1  # a dead row (every page unmapped)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    ql_t = (torch.tensor(q_len, dtype=torch.int32, device=dev)
            if mixed else None)
    return q, pool_k, pool_v, table, pos_t, ql_t, kw


def _pools(torch, gen, fmt, dtype, N, P, KV, hd):
    """(pool_k, pool_v, kw): normal draws in `dtype`, or with fmt
    "int8"/"int4" normal draws written by the port's qwrite_prompt_pages
    (the kernel's scale arguments go in kw), or with fmt "f8_e4m3" /
    "f8_e5m2" normal draws cast to fp8 as the port's writers cast them."""
    from cake_tpu_torch.kv.quantized_pool import (
        Int4Pool, QuantPool, qwrite_prompt_pages,
    )

    dev = "cuda"
    if fmt is None:
        return tuple(torch.randn((N, P, KV, hd), generator=gen, device=dev,
                                 dtype=dtype) for _ in range(2)) + ({},)
    if fmt in FP8_FORMATS:
        from cake_tpu_torch.utils.devices import to_storage
        dt = getattr(torch, FP8_FORMATS[fmt])
        return tuple(to_storage(torch.randn((N, P, KV, hd), generator=gen,
                                            device=dev), dt)
                     for _ in range(2)) + ({},)
    cls, rows = (Int4Pool, P // 2) if fmt == "int4" else (QuantPool, P)
    every = torch.arange(N, dtype=torch.int32, device=dev)
    pools = []
    for _ in range(2):
        pool = cls(torch.zeros((N, rows, KV, hd), device=dev,
                               dtype=(torch.uint8 if fmt == "int4"
                                      else torch.int8)),
                   torch.zeros((N, KV), device=dev))
        vals = torch.randn((1, N * P, KV, hd), generator=gen, device=dev)
        pools.append(qwrite_prompt_pages(pool, vals, every))
        del vals
    (pool_k, sk), (pool_v, sv) = pools
    return pool_k, pool_v, dict(scale_k=sk, scale_v=sv,
                                packed4=fmt == "int4")


def _dequantized(torch, pool_k, pool_v, kw, dtype):
    """A quantized pool pair's pages dequantized to `dtype` ahead of
    time (the SDPA yardstick's K/V), an fp8 pair upcast to `dtype`;
    f32/bf16 pools as they are."""
    from cake_tpu_torch.kv.quantized_pool import (
        Int4Pool, QuantPool, dequantize_pages,
    )

    if pool_k.element_size() == 1 and not kw:           # fp8
        return pool_k.to(dtype), pool_v.to(dtype)
    if not kw:
        return pool_k, pool_v
    cls = Int4Pool if kw["packed4"] else QuantPool
    every = torch.arange(pool_k.shape[0], device=pool_k.device)
    return tuple(dequantize_pages(cls(x, kw[s]), every).to(dtype)
                 for x, s in ((pool_k, "scale_k"), (pool_v, "scale_v")))


def _cold_copies(torch, pool_k, pool_v, kw):
    """[(pool_k, pool_v, kw)] copies of a pool pair (scales cloned with
    their pages) that together exceed the L2 cache twice over, so a
    replayed burst of calls cycling through them finds each copy's pages
    cold, as a served decode step finds each layer's pool."""
    nbytes = 2 * pool_k.numel() * pool_k.element_size()
    out = [(pool_k, pool_v, kw)]
    for a, b in zip(_copies(pool_k, nbytes)[1:], _copies(pool_v, nbytes)[1:]):
        out.append((a, b, {k: (v.clone() if torch.is_tensor(v) else v)
                           for k, v in kw.items()}))
    return out


def _decode_pools(torch, pool_k, pool_v, kw, dtype):
    """(kernel pools, SDPA pools) of a decode case, each cycled past L2:
    [(pool_k, pool_v, kw)] for the kernel, [(k, v)] for the yardstick
    (a quantized pool's pages dequantized to `dtype` ahead of time)."""
    kpools = _cold_copies(torch, pool_k, pool_v, kw)
    if not kw and pool_k.element_size() > 1:
        return kpools, [(a, b) for a, b, _ in kpools]
    dk, dv = _dequantized(torch, pool_k, pool_v, kw, dtype)
    return kpools, [(a, b) for a, b, _ in _cold_copies(torch, dk, dv, {})]


def _elem_bytes(fmt, pool_k):
    """(bytes a K/V element, bytes a live page adds: its k and v scales,
    4 each a kv head) of a pool stored as fmt (None: q's dtype; fp8: one
    byte an element, no scales)."""
    if fmt is None or fmt in FP8_FORMATS:
        return pool_k.element_size(), 0
    return _ELEM_BYTES[fmt], 8 * pool_k.shape[2]


def _work(q, P, KV, table, pos, q_len, elem_bytes, page_bytes=0):
    """(bytes, operations) the function needs on these inputs: every
    live, mapped K/V slot (elem_bytes per element) and the table entries
    of the live range read once, plus page_bytes per live mapped page
    (the scales of quantized pages); q read only for the query columns
    that attend to a slot (the output is zero elsewhere, whatever q
    holds); the whole output written once; 4*hd operations per (query
    head, attended slot)."""
    B, C, H, hd = q.shape
    tab = table.tolist()
    pos_l = pos.tolist()
    ql = q_len.tolist() if q_len is not None else [1] * B
    kv_slots = 0
    live_pages = 0
    attended = 0
    q_cols = 0
    table_entries = 0
    for b in range(B):
        if ql[b] == 0:
            continue
        last = pos_l[b] + ql[b] - 1
        n_pages = min(len(tab[b]), last // P + 1)
        table_entries += n_pages
        per_col = [0] * ql[b]
        for j in range(n_pages):
            if tab[b][j] < 0:
                continue
            lo = j * P
            live_pages += 1
            kv_slots += min(P, last - lo + 1)
            for i in range(ql[b]):
                per_col[i] += max(0, min(P, pos_l[b] + i - lo + 1))
        attended += sum(per_col)
        q_cols += sum(1 for n in per_col if n > 0)
    row_bytes = H * hd * q.element_size()
    nbytes = (2 * kv_slots * KV * hd * elem_bytes + live_pages * page_bytes
              + q_cols * row_bytes + B * C * row_bytes
              + table_entries * 4
              + 4 * B * (2 if q_len is not None else 1))
    ops = 4 * hd * attended * (H // KV) * KV
    return int(nbytes), ops


def _sdpa_yardstick(torch, q, pool_k, pool_v, table, pos, q_len):
    """One `scaled_dot_product_attention(enable_gqa=True)` call on dense
    K/V gathered to the same live lengths (a yardstick only: the port
    never calls it). Returns a closure timing just that call."""
    import torch.nn.functional as F
    B, C, H, hd = q.shape
    _, P, KV, _ = pool_k.shape
    ql = q_len if q_len is not None else torch.ones_like(pos)
    last = pos.long() + ql.long().clamp(min=1) - 1
    n_pages = int((last.max() // P + 1).item())
    idx = table[:, :n_pages].long().clamp(min=0)
    T = n_pages * P
    k = pool_k[idx].reshape(B, T, KV, hd).transpose(1, 2).contiguous()
    v = pool_v[idx].reshape(B, T, KV, hd).transpose(1, 2).contiguous()
    qq = q.transpose(1, 2).contiguous()                     # [B, H, C, hd]
    cols = torch.arange(T, device=q.device)
    horizon = pos.long()[:, None] + torch.arange(C, device=q.device)
    mapped = (table[:, :n_pages] >= 0).repeat_interleave(P, dim=1)
    mask = (cols[None, None, :] <= horizon[:, :, None]) & mapped[:, None, :]
    mask = mask[:, None]                                    # [B,1,C,T]
    return lambda: F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def _measure(torch, label, dname, got, want, kerns, plain, libs, nbytes,
             ops, again=None) -> dict:
    """Hold one kernel output against its plain version (and, given
    `again`, a second launch on the same inputs against the first, bit
    for bit), then time the kernel, the plain version and the yardstick
    on the same inputs. kerns / libs: the kernel's and the yardstick's
    calls, one per copy of the inputs where a copy is cycled through (see
    _stream_ms): device time by graph replay, the host-launched time
    beside it. The plain version is timed from the host (milliseconds)."""
    torch.cuda.synchronize()
    if not torch.isfinite(got.float()).all():
        fail(f"{label} {dname}: non-finite output")
    if again is not None and not torch.equal(got, again):
        fail(f"{label} {dname}: two launches on the same inputs differ")
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **TOL[dname]):
        fail(f"{label} {dname}: max |kernel - plain| = {err:.3e} over "
             f"tolerance {TOL[dname]}")
    ms, eager_ms = _stream_ms(torch, kerns)
    plain_ms = _time_ms(torch, plain, reps=10, warmup=1)
    lib_ms, lib_eager_ms = _stream_ms(torch, libs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dname] * 1e3
    rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=lib_ms, bytes=nbytes, ops=ops, eager_ms=eager_ms,
               library_eager_ms=lib_eager_ms)
    log(f"{label} {dname}: max_abs_err {err:.3e} (tol {TOL[dname]}"
        f"{', same bits twice' if again is not None else ''}); "
        f"{ms:.4f} ms kernel ({eager_ms:.4f} eager), {plain_ms:.4f} ms plain, "
        f"{lib_ms:.4f} ms sdpa ({lib_eager_ms:.4f} eager), bound "
        f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}: {nbytes} B, {ops} "
        f"ops); {rec['bound_ms'] and ms / rec['bound_ms']:.1f}x bound")
    return rec


# bytes per K/V element of a quantized page; each live page also reads
# its k and v scales, 2 * 4 bytes per kv head
_ELEM_BYTES = {"int8": 1.0, "int4": 0.5}


def _kernel_suffix(fmt) -> str:
    """The suffix of the kernel names that serve a pool stored as fmt."""
    return {"int8": "_q8", "int4": "_q4", "f8_e4m3": "_f8e4m3",
            "f8_e5m2": "_f8e5m2"}.get(fmt, "")


def _rpa_kernels(torch, rpa, report, only=None) -> None:
    """The ragged kernels over f32/bf16 pages, then over int8 and int4
    pages. The quantized cases' yardstick is SDPA over the same live
    pages dequantized to q's dtype ahead of the call: it reads 2x (int8)
    or 4x (int4) the page bytes of a bf16 pool and dequantizes nothing.
    The decode kernels (every pool) cycle through pool copies larger than
    L2, and SDPA through copies of its own pages (a served decode step
    finds each layer's pool cold). Then over fp8 e4m3 and e5m2 pages (no
    scales; the bound at one byte an element, the yardstick SDPA over
    bf16 copies of the pages). Every kernel must give the same bits
    twice. `only`: the kernel names to run (None: all)."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    fmts = (None, "int8", "int4") + (
        tuple(FP8_FORMATS) if hasattr(rpa, "_FP8_SUFFIX") else ())
    for fmt in fmts:
        for base, mixed in (("rpa_decode", False), ("rpa_mixed", True)):
            kern = (rpa.ragged_paged_attention_mixed if mixed
                    else rpa.ragged_paged_attention)
            plain = (rpa.ragged_paged_attention_mixed_plain if mixed
                     else rpa.ragged_paged_attention_plain)
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[-1]
                q, pk, pv, table, pos, ql, kw = _kernel_case(
                    torch, dtype, gen, mixed, fmt)
                name = base + _kernel_suffix(fmt)
                if only is not None and name not in only:
                    continue
                args = (q, pk, pv, table, pos) + ((ql,) if mixed else ())
                got = kern(*args, **kw)
                # the dead row (and the mixed case's idle row) must come
                # back as exact zeros
                for dead in ((4, 3) if mixed else (7,)):
                    if got[dead].abs().max().item() != 0.0:
                        fail(f"{name} {dname}: dead row {dead} is not zero")
                KV = pk.shape[2]
                P = pk.shape[1] * (2 if fmt == "int4" else 1)
                nbytes, ops = _work(q, P, KV, table, pos, ql,
                                    *_elem_bytes(fmt, pk))
                if mixed:
                    kpools = [(pk, pv, kw)]
                    dpools = [_dequantized(torch, pk, pv, kw, dtype)]
                else:
                    kpools, dpools = _decode_pools(torch, pk, pv, kw, dtype)
                    plan = rpa.split_plan(q.shape[0], KV, table.shape[1], P,
                                          rpa.sm_count("cuda"))
                    log(f"{name} {dname}: split plan (splits, pages a "
                        f"split) {plan}; {len(kpools)} pool copies")
                rest = args[3:]
                report[(name, dname)] = _measure(
                    torch, name, dname, got, plain(*args, **kw),
                    [(lambda a=a, b=b, k=k: kern(q, a, b, *rest, **k))
                     for a, b, k in kpools],
                    lambda: plain(*args, **kw),
                    [_sdpa_yardstick(torch, q, c, d, table, pos, ql)
                     for c, d in dpools],
                    nbytes, ops, again=kern(*args, **kw))
                if mixed and hasattr(rpa, "mixed_split_plan"):
                    log(f"{name} {dname}: "
                        + _mixed_body(rpa, q, pk, pv, kw, table.shape[1], P))
                del kpools, dpools
    torch.cuda.empty_cache()


def _mixed_body(rpa, q, pool_k, pool_v, kw, max_pages, P) -> str:
    """Which body the package's mixed wrapper launches for these inputs,
    and its split plan (planned with the real page size P)."""
    if not rpa.mixed_takes_tc(q, pool_k, pool_v, kw.get("scale_k")):
        return "rpa_cta"
    plan = rpa.mixed_split_plan(*q.shape[:3], pool_k.shape[2], q.shape[3],
                                max_pages, P, rpa.sm_count("cuda"))
    return f"tensor-core body, plan (splits, pages a split) {plan}"


def _split_cases(torch, rpa, only=None) -> None:
    """Decode cases that show the split of rpa_decode (bf16 queries,
    128-token pages, H=32, KV=8, hd=128; pools cycled past L2): B = 8
    with one row at pos 8191 (64 table columns) beside rows at 0..2047,
    over a bf16, an int8, an int4, an fp8 e4m3 and an fp8 e5m2 pool
    (rpa_decode, rpa_decode_q8, rpa_decode_q4, rpa_decode_f8e4m3,
    rpa_decode_f8e5m2), and B = 32 rows at mixed positions up to 2047
    over a bf16 pool. Each against its plain version, with the plan,
    device time, bound and SDPA (over the pages dequantized, or upcast,
    to bf16 for the quantized and fp8 pools). `only`: the kernel names to
    run (None: all)."""
    gen = torch.Generator(device="cuda").manual_seed(777)
    H, KV, hd, P, dtype = 32, 8, 128, 128, torch.bfloat16
    long_row = [8191, 0, 127, 500, 1000, 1500, 2047, 300]
    cases = (
        ("B=8 one row at 8191", 8, 64, long_row, None),
        ("B=32 mixed up to 2047", 32, 16,
         [int(x) for x in torch.randint(0, 2048, (32,), generator=gen,
                                        device="cuda").tolist()], None),
        ("B=8 one row at 8191", 8, 64, long_row, "int8"),
        ("B=8 one row at 8191", 8, 64, long_row, "int4"),
        ("B=8 one row at 8191", 8, 64, long_row, "f8_e4m3"),
        ("B=8 one row at 8191", 8, 64, long_row, "f8_e5m2"),
    )
    for label, B, MP, pos_l, fmt in cases:
        name = "rpa_decode" + _kernel_suffix(fmt)
        if fmt in FP8_FORMATS and not hasattr(rpa, "_FP8_SUFFIX"):
            continue
        if only is not None and name not in only:
            continue
        N = 256
        pk, pv, kw = _pools(torch, gen, fmt, dtype, N, P, KV, hd)
        table = torch.randint(0, N, (B, MP), generator=gen, device="cuda",
                              dtype=torch.int32)
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
        q = torch.randn((B, 1, H, hd), generator=gen, device="cuda",
                        dtype=dtype)
        args = (q, pk, pv, table, pos)
        got = rpa.ragged_paged_attention(*args, **kw)
        kpools, dpools = _decode_pools(torch, pk, pv, kw, dtype)
        nbytes, ops = _work(q, P, KV, table, pos, None, *_elem_bytes(fmt, pk))
        plan = (rpa.split_plan(B, KV, MP, P, rpa.sm_count("cuda"))
                if hasattr(rpa, "split_plan") else "none")
        log(f"{name} split case {label}: plan (splits, pages a split) "
            f"{plan}")
        _measure(torch, f"{name} {label}", "bfloat16", got,
                 rpa.ragged_paged_attention_plain(*args, **kw),
                 [(lambda a=a, b=b, k=k: rpa.ragged_paged_attention(
                     q, a, b, table, pos, **k)) for a, b, k in kpools],
                 lambda: rpa.ragged_paged_attention_plain(*args, **kw),
                 [_sdpa_yardstick(torch, q, a, b, table, pos, None)
                  for a, b in dpools], nbytes, ops,
                 again=rpa.ragged_paged_attention(*args, **kw))
        del kpools, dpools, pk, pv
        torch.cuda.empty_cache()


# (label, kernel, shapes, options, the case the kernel table reports).
# B=1, H=32, KV=8, hd=128: Llama-3-8B prefill of one prompt.
FLASH_CASES = (
    ("flash_attn causal S=T=1024", "flash_attn",
     dict(S=1024, T=1024, pos=None), dict(), True),
    ("flash_attn window 256 S=T=1024", "flash_attn",
     dict(S=1024, T=1024, pos=None), dict(window=256), False),
    ("flash_attn non-causal S=256 T=1024", "flash_attn",
     dict(S=256, T=1024, pos=None), dict(causal=False), False),
    ("flash_attn_cached S=256 pos=1280 T=4096 NaN tail",
     "flash_attn_cached", dict(S=256, T=4096, pos=1280), dict(), True),
    ("flash_attn_cached S=256 pos=1301 T=4096 window 700 NaN tail",
     "flash_attn_cached", dict(S=256, T=4096, pos=1301), dict(window=700),
     False),
    # the prefix phase's shapes: a 5-page prefix registration, the
    # prefixed suffix window, and a chunk window over a slot's whole
    # gathered row (max_seq_len 2048), whose unmapped pages read as zeros
    ("flash_attn causal S=T=640 (prefix registration)", "flash_attn",
     dict(S=640, T=640, pos=None), dict(), False),
    ("flash_attn_cached S=128 pos=640 T=768 NaN tail (prefixed suffix)",
     "flash_attn_cached", dict(S=128, T=768, pos=640), dict(), False),
    ("flash_attn_cached S=64 pos=704 T=2048 zero tail (chunk window)",
     "flash_attn_cached", dict(S=64, T=2048, pos=704, tail=0.0), dict(),
     False),
)


def _flash_work(B, S, T, H, KV, hd, pos, causal, window, elem_bytes):
    """(bytes, operations) of one flash call on these shapes: q read and
    the output written once, every key some query attends read once (k
    and v), 4*hd operations per attended (query head, key) pair."""
    base = 0 if pos is None else pos
    pairs = 0
    for i in range(S):
        qp = base + i
        hi = qp + 1 if causal else T
        lo = max(0, qp - window + 1) if window else 0
        pairs += hi - lo
    first_lo = max(0, base - window + 1) if window else 0
    keys = (base + S if causal else T) - first_lo
    nbytes = (2 * B * S * H * hd + 2 * B * keys * KV * hd) * elem_bytes
    return nbytes, 4 * hd * pairs * B * H


def _flash_sdpa(torch, q, k, v, pos, causal, window):
    """One `scaled_dot_product_attention(enable_gqa=True)` call on the
    same q/k/v (a cached case's k/v cut at the frontier, whose NaN tail
    SDPA would carry into 0 * NaN); a yardstick only, the port never
    calls it. Returns a closure timing just that call."""
    import torch.nn.functional as F
    S = q.shape[1]
    if pos is not None:
        k, v = k[:, :pos + S], v[:, :pos + S]
    qq, kk, vv = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if not causal:
        return lambda: F.scaled_dot_product_attention(qq, kk, vv,
                                                      enable_gqa=True)
    if pos is None and window is None and k.shape[1] == S:
        return lambda: F.scaled_dot_product_attention(
            qq, kk, vv, is_causal=True, enable_gqa=True)
    qp = (0 if pos is None else pos) + torch.arange(S, device=q.device)
    kp = torch.arange(k.shape[1], device=q.device)
    mask = kp[None, :] <= qp[:, None]
    if window is not None:
        mask &= kp[None, :] > qp[:, None] - window
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask,
                                                  enable_gqa=True)


def _flash_kernels(torch, fa, report, only=None) -> None:
    gen = torch.Generator(device="cuda").manual_seed(4321)
    B, H, KV, hd = 1, 32, 8, 128
    for label, name, shp, kw, main_case in FLASH_CASES:
        if only is not None and name not in only:
            continue
        S, T, pos = shp["S"], shp["T"], shp["pos"]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q = torch.randn((B, S, H, hd), generator=gen, device="cuda",
                            dtype=dtype)
            k = torch.randn((B, T, KV, hd), generator=gen, device="cuda",
                            dtype=dtype)
            v = torch.randn((B, T, KV, hd), generator=gen, device="cuda",
                            dtype=dtype)
            if pos is None:
                args = (q, k, v)
                kern, plain = fa.flash_attention, fa.flash_attention_plain
            else:
                # slots at or past the frontier hold garbage (NaN), or
                # the zeros of unmapped pages
                k[:, pos + S:] = shp.get("tail", float("nan"))
                v[:, pos + S:] = shp.get("tail", float("nan"))
                # the kernel reads pos from the card where the tree's
                # wrapper takes a device tensor (an earlier tree's takes
                # an int)
                args = (q, k, v, torch.tensor([pos], dtype=torch.int32,
                                              device="cuda")
                        if hasattr(fa, "_device_pos") else pos)
                kern = fa.flash_attention_cached
                plain = fa.flash_attention_cached_plain
            causal = kw.get("causal", True)
            window = kw.get("window")
            nbytes, ops = _flash_work(B, S, T, H, KV, hd, pos, causal,
                                      window, q.element_size())
            rec = _measure(
                torch, label, dname, kern(*args, **kw), plain(*args, **kw),
                [lambda: kern(*args, **kw)], lambda: plain(*args, **kw),
                [_flash_sdpa(torch, q, k, v, pos, causal, window)], nbytes,
                ops, again=kern(*args, **kw))
            if pos is not None and hasattr(fa, "flash_split_plan") and \
                    dtype != torch.float32:
                n_sm = fa.device_sm_count("cuda")
                splits = fa.flash_split_plan(B, S, T, H, KV, n_sm,
                                             fa.CACHED_WARPS)
                log(f"{label} {dname}: tensor-core body, {fa.CACHED_WARPS} "
                    f"warps a CTA, {splits} key splits on {n_sm} SMs")
            if main_case:
                report[(name, dname)] = rec


# (In, Out) of the Llama-3-8B block weights: wq/wo, wk/wv, w_gate/w_up,
# w_down; g = 128. The kernel table reports w_gate/w_up (INT4_MAIN) at
# each of INT4_MS
INT4_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
INT4_MAIN = (4096, 14336)
# int4_matmul against its plain version: the same products summed in f32
# in another order (for bf16 and f16 x every product is exact in f32), so
# at f32 the difference stays under 1e-5 of the largest output; at bf16 and
# f16 the two f32 sums round apart by at most one unit, 2^-7 and 2^-10
# relative
INT4_ATOL_OF_MAX = 1e-5
INT4_RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
# the M of the kernel table's row 9: the generator's decode step, the served
# decode launch, the largest the gate takes
INT4_MS = (1, 8, 64)


def _stream_ms(torch, fns, reps: int = 30, rounds: int = 5):
    """(device ms, eager ms) of one call, each the median over `rounds`
    of the mean of `reps` back-to-back calls cycling through `fns`: the
    same function over copies of its weight that together exceed the L2
    cache, so each call streams its weight from device memory as a
    layer's does in a decode step. Device: the calls captured once into
    a CUDA graph and replayed, so no host time lies between the
    launches; eager: the calls made from Python, where a product of a
    few microseconds waits for its wrapper."""
    def burst():
        for i in range(reps):
            fns[i % len(fns)]()

    def timed(fn):
        times = []
        for _ in range(rounds):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return statistics.median(times)

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    eager = timed(burst)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm up on the capture's own stream
        burst()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        burst()
    graph.replay()
    torch.cuda.synchronize()
    device = timed(graph.replay)
    del graph
    return device, eager


def _copies(t, nbytes: int):
    """t and enough clones of it to hold 100 MB, twice the L2 cache."""
    n = max(2, -(-100_000_000 // max(nbytes, 1)))
    return [t] + [t.clone() for _ in range(n - 1)]


def _int4_plan(torch, i4, M, In, Out, g, dtype) -> str:
    """The body and split plan a product runs (a tree without the
    tensor-core body says so)."""
    if not hasattr(i4, "split_plan"):
        return "CUDA-core body, split + sum kernel"
    from cake_tpu_torch.utils.devices import device_sm_count

    tc = i4.takes_tc(M, g, dtype)
    s = i4.split_plan(M, In // g, Out, tc, device_sm_count("cuda"))
    return (f"{'tensor-core' if tc else 'CUDA-core'} body, clusters of "
            f"{s} over {In // g} groups")


def _int4_kernels(torch, i4, report) -> None:
    from cake_tpu_torch.ops.quant import group_size, quantize_group

    gen = torch.Generator(device="cuda").manual_seed(99)
    shapes = [(m, i, o) for (i, o) in INT4_SHAPES for m in INT4_MS]
    shapes.append((2, 64, 32))         # the tiny config's wk/wv, g = 64
    weights = {}
    for M, In, Out in shapes:
        if (In, Out) not in weights:
            w = torch.randn((In, Out), generator=gen, device="cuda")
            weights[(In, Out)] = quantize_group(w * In ** -0.5, 0)
            del w
        qt = weights[(In, Out)]
        g = group_size(qt)
        main = (In, Out) == INT4_MAIN
        dtypes = (torch.float32, torch.bfloat16) + ((torch.float16,)
                                                    if main else ())
        for dtype in dtypes:
            dname = str(dtype).split(".")[-1]
            x = torch.randn((M, In), generator=gen, device="cuda").to(dtype)
            n0 = i4.LAUNCHES["int4_matmul"]
            got = i4.int4_matmul(x, qt.q, qt.scale, g=g)
            launches = i4.LAUNCHES["int4_matmul"] - n0
            again = i4.int4_matmul(x, qt.q, qt.scale, g=g)
            want = i4.int4_matmul_plain(x, qt.q, qt.scale, g=g)
            torch.cuda.synchronize()
            label = f"int4_matmul M={M} In={In} Out={Out} g={g} {dname}"
            if launches != 1:
                fail(f"{label}: {launches} launches counted for one product")
            if not torch.isfinite(got.float()).all():
                fail(f"{label}: non-finite output")
            if not torch.equal(got, again):
                fail(f"{label}: two launches on the same inputs differ")
            err = (got.float() - want.float()).abs().max().item()
            atol = INT4_ATOL_OF_MAX * want.float().abs().max().item()
            if not torch.allclose(got.float(), want.float(), atol=atol,
                                  rtol=INT4_RTOL[dname]):
                fail(f"{label}: max |kernel - plain| = {err:.3e} over "
                     f"atol {atol:.3e} rtol {INT4_RTOL[dname]}")
            plan = _int4_plan(torch, i4, M, In, Out, g, dtype)
            if In < 1024:
                log(f"{label}: max_abs_err {err:.3e} (atol {atol:.3e}); "
                    f"{plan}")
                continue
            wbytes = qt.q.numel() + 4 * qt.scale.numel()
            nbytes = wbytes + (M * In + M * Out) * x.element_size()
            ops = 2 * M * In * Out
            qs = _copies(qt.q, wbytes)
            ss = [qt.scale.clone() for _ in qs]
            ms, eager_ms = _stream_ms(torch, [
                (lambda q=q, s=s: i4.int4_matmul(x, q, s, g=g))
                for q, s in zip(qs, ss)])
            plain_ms = _time_ms(
                torch, lambda: i4.int4_matmul_plain(x, qt.q, qt.scale, g=g),
                reps=5, warmup=1)
            # yardstick: one torch.matmul over the weight dequantized to
            # x's dtype ahead of time (4x or 8x the bytes, no unpacking)
            wd = (i4.unpack_int4(qt.q, g).to(dtype).reshape(In // g, g, Out)
                  * qt.scale[:, None, :].to(dtype)).reshape(In, Out)
            wds = _copies(wd, wd.numel() * wd.element_size())
            lib_ms, lib_eager_ms = _stream_ms(
                torch, [(lambda w=w: torch.matmul(x, w)) for w in wds])
            del qs, ss, wd, wds
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / PEAK_OPS[dname] * 1e3
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       library_ms=lib_ms, bytes=nbytes, ops=ops,
                       eager_ms=eager_ms, library_eager_ms=lib_eager_ms)
            log(f"{label}: max_abs_err {err:.3e} (atol {atol:.3e}, rtol "
                f"{INT4_RTOL[dname]}); {ms:.4f} ms kernel ({eager_ms:.4f} "
                f"eager), {plain_ms:.4f} ms plain, {lib_ms:.4f} ms matmul of "
                f"the dequantized weight ({lib_eager_ms:.4f} eager), bound "
                f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}: {nbytes} B, "
                f"{ops} ops), x{ms / rec['bound_ms']:.1f} bound; {plan}")
            if main:
                report[("int4_matmul", dname, M)] = rec
    torch.cuda.empty_cache()


def int4_sweep(torch, i4, splits) -> None:
    """Device time of int4_matmul (graph replay, bf16 x, each of INT4_MS)
    at the four Llama-3-8B weight shapes: the plan's own clusters, then
    each cluster size in `splits` (cut to one with no empty range); at
    M = 1 for both bodies (TC_MIN_M 1: tensor cores, 2: CUDA cores)."""
    from cake_tpu_torch.ops.quant import group_size, quantize_group
    from cake_tpu_torch.utils.devices import device_sm_count

    plan, tc_min = i4.split_plan, i4.TC_MIN_M
    n_sm = device_sm_count("cuda")
    gen = torch.Generator(device="cuda").manual_seed(99)
    for In, Out in INT4_SHAPES:
        w = torch.randn((In, Out), generator=gen, device="cuda")
        qt = quantize_group(w * In ** -0.5, 0)
        del w
        g = group_size(qt)
        G = In // g
        wbytes = qt.q.numel() + 4 * qt.scale.numel()
        qs = _copies(qt.q, wbytes)
        ss = [qt.scale.clone() for _ in qs]
        for M in INT4_MS:
            x = torch.randn((M, In), generator=gen,
                            device="cuda").to(torch.bfloat16)
            cells = []
            for body in ((1, 2) if M == 1 else (tc_min,)):
                i4.TC_MIN_M = body
                tc = i4.takes_tc(M, g, x.dtype)
                for n in [None] + list(splits):
                    fixed = -(-G // -(-G // min(n, G))) if n else None
                    i4.split_plan = plan if n is None else (
                        lambda *a, f=fixed: f)
                    ms, _ = _stream_ms(torch, [
                        (lambda q=q, s=s: i4.int4_matmul(x, q, s, g=g))
                        for q, s in zip(qs, ss)])
                    used = fixed or plan(M, G, Out, tc, n_sm)
                    cells.append(f"{'tc' if tc else 'core'} {used}"
                                 f"{'' if n else ' (plan)'}: {ms:.4f} ms")
            i4.split_plan, i4.TC_MIN_M = plan, tc_min
            log(f"int4 sweep M={M} In={In} Out={Out}: " + ", ".join(cells))
        del qs, ss
        torch.cuda.empty_cache()


def phase_kernels(torch, rpa, fa, i4, only=None) -> dict:
    """Every kernel against its plain version, timed; `only` restricts
    the phase to some kernel names (with a decode kernel, its split
    cases)."""
    report = {}
    _rpa_kernels(torch, rpa, report, only)
    _split_cases(torch, rpa, only)
    _flash_kernels(torch, fa, report, only)
    if only is None or "int4_matmul" in only:
        _int4_kernels(torch, i4, report)
    return report


# -- phase: step --------------------------------------------------------------


def phase_step(torch, rpa, fa, i4) -> None:
    """At 8B width (2 layers, f32): mixed_step_paged then
    decode_step_ragged_paged, attn='kernel' vs attn='plain' from identical
    pools; then the dense prefill, prefill_chunk and decode_step with
    flash on (the CUDA kernels) vs off (the masked einsum)."""
    import dataclasses

    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.model import RopeTables
    from cake_tpu_torch.models.llama.paged import (
        PagedKVCache, decode_step_ragged_paged, mixed_step_paged,
        table_set_slot,
    )
    from cake_tpu_torch.models.llama.params import init_params

    dev = "cuda"
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_hidden_layers=2)
    gen = torch.Generator(device=dev).manual_seed(7)
    params = init_params(cfg, gen, device=dev, dtype=torch.float32)
    B, C, P, T = 4, 64, 128, 1024
    rope = RopeTables.create(cfg, T, device=dev)
    base = PagedKVCache.create(cfg, B, 32, P, T, dtype=torch.float32,
                               device=dev)
    for slot in range(B):
        table_set_slot(base.table, slot, list(range(slot * 8,
                                                    slot * 8 + 8)))
    # a decode row at 300 (its history is random), two chunk rows at odd
    # page offsets, an idle row
    base.k.normal_(generator=gen)
    base.v.normal_(generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (B, C), generator=gen,
                           device=dev, dtype=torch.int32)
    pos = torch.tensor([300, 100, 5, 0], dtype=torch.int32, device=dev)
    q_len = torch.tensor([1, 64, 37, 0], dtype=torch.int32, device=dev)
    active = q_len > 0
    out = {}
    for attn in ("kernel", "plain"):
        cache = base.clone()
        lm, _ = mixed_step_paged(params, tokens, pos, q_len, active,
                                 cache, rope, cfg, attn=attn)
        dpos = pos + q_len.clamp(min=1) - 1 + 1
        ld, _ = decode_step_ragged_paged(params, tokens[:, :1], dpos,
                                         active, cache, rope, cfg,
                                         attn=attn)
        torch.cuda.synchronize()
        out[attn] = (lm, ld, cache)
    (lm_k, ld_k, ck), (lm_p, ld_p, cp) = out["kernel"], out["plain"]
    rows = active.nonzero().flatten()
    for what, a, b in (("mixed", lm_k, lm_p), ("decode", ld_k, ld_p)):
        err = (a[rows] - b[rows]).abs().max().item()
        log(f"step {what} logits: max |kernel - plain| = {err:.3e}")
        if not torch.isfinite(a[rows]).all() or err > 1e-3:
            fail(f"step {what}: logits differ by {err:.3e} (tol 1e-3)")
    # layer 0's pool writes see identical inputs; deeper layers' K/V
    # inherit the attention's summation-order differences
    if not (torch.equal(ck.k[0], cp.k[0]) and torch.equal(ck.v[0], cp.v[0])):
        fail("step: layer-0 pools differ between kernel and plain")
    perr = max((ck.k - cp.k).abs().max().item(),
               (ck.v - cp.v).abs().max().item())
    log(f"step pools: layer 0 identical, max |kernel - plain| = {perr:.3e}")
    if perr > 1e-4:
        fail(f"step: pools differ by {perr:.3e} (tol 1e-4)")
    del out, base
    _quant_steps(torch, rpa, cfg, params, rope, gen)
    _dense_step(torch, fa, cfg, params, rope, gen)
    _int4_steps(torch, i4, cfg, params, rope, gen)
    del params
    torch.cuda.empty_cache()


# logits tolerance of the quantized steps, kernel vs plain: f32 queries
# and the same dequantized pages, so the attention differs only in
# summation order; but layer 1 quantizes K/V that inherit layer 0's
# differences, and a value that lands on a rounding edge moves by one
# step (1/127 or 1/7 of its page's amax)
QSTEP_TOL = {"int8": 1e-3, "int4": 1e-2}


def _quant_steps(torch, rpa, cfg, params, rope, gen) -> None:
    """The 8B-width 2-layer mixed and decode steps over an int8 and an
    int4 pool, kernel vs plain from identical pools (every page of every
    layer written by qwrite_prompt_pages from a normal draw)."""
    from cake_tpu_torch.kv.quantized_pool import (
        QUANTIZED_CACHES, qwrite_prompt_pages,
    )
    from cake_tpu_torch.models.llama.paged import (
        decode_step_ragged_paged, mixed_step_paged, table_set_slot,
    )

    dev = "cuda"
    B, C, P, T, N = 4, 64, 128, 1024, 32
    L, KV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    tokens = torch.randint(0, cfg.vocab_size, (B, C), generator=gen,
                           device=dev, dtype=torch.int32)
    pos = torch.tensor([300, 100, 5, 0], dtype=torch.int32, device=dev)
    q_len = torch.tensor([1, 64, 37, 0], dtype=torch.int32, device=dev)
    active = q_len > 0
    rows = active.nonzero().flatten()
    every = torch.arange(N, dtype=torch.int32, device=dev)
    for fmt, cls in QUANTIZED_CACHES.items():
        base = cls.create(cfg, B, N, P, T, device=dev)
        for slot in range(B):
            table_set_slot(base.table, slot, list(range(slot * 8,
                                                        slot * 8 + 8)))
        for i in range(L):
            for leaf in base.layer(i):
                vals = torch.randn((1, N * P, KV, hd), generator=gen,
                                   device=dev)
                qwrite_prompt_pages(leaf, vals, every)
        out = {}
        for attn in ("kernel", "plain"):
            cache = base.clone()
            rpa.reset_launch_counts()
            lm, _ = mixed_step_paged(params, tokens, pos, q_len, active,
                                     cache, rope, cfg, attn=attn)
            dpos = pos + q_len.clamp(min=1)
            ld, _ = decode_step_ragged_paged(params, tokens[:, :1], dpos,
                                             active, cache, rope, cfg,
                                             attn=attn)
            torch.cuda.synchronize()
            out[attn] = (lm, ld, cache, dict(rpa.LAUNCHES))
        (lm_k, ld_k, ck, nk), (lm_p, ld_p, cp, np_) = out["kernel"], \
            out["plain"]
        suffix = "_q4" if fmt == "int4" else "_q8"
        for attn, n, plain_n in (("kernel", nk, 0), ("plain", np_, L)):
            for b in ("rpa_mixed", "rpa_decode"):
                got = (n[b + suffix], n[b + suffix + "_plain"])
                want = (L - plain_n, plain_n)
                if got != want:
                    fail(f"step {fmt} ({attn}): {b}{suffix} launches/plain "
                         f"{got}, expected {want}")
        for what, a, b in (("mixed", lm_k, lm_p), ("decode", ld_k, ld_p)):
            err = (a[rows] - b[rows]).abs().max().item()
            log(f"step {fmt} {what} logits: max |kernel - plain| = "
                f"{err:.3e} (tol {QSTEP_TOL[fmt]})")
            if not torch.isfinite(a[rows]).all() or err > QSTEP_TOL[fmt]:
                fail(f"step {fmt} {what}: logits differ by {err:.3e}")
        if not all(torch.equal(x.q[0], y.q[0]) and torch.equal(
                x.scale[0], y.scale[0]) for x, y in ((ck.k, cp.k),
                                                     (ck.v, cp.v))):
            fail(f"step {fmt}: layer-0 pools differ between kernel and plain")
        steps = 0
        for x, y in ((ck.k, cp.k), (ck.v, cp.v)):
            a, b = x.q.int(), y.q.int()
            if fmt == "int4":     # compare each nibble
                a = torch.cat([a & 0xF, a >> 4])
                b = torch.cat([b & 0xF, b >> 4])
            steps = max(steps, (a - b).abs().max().item())
        log(f"step {fmt} pools: layer 0 identical, largest difference "
            f"{steps} quantization step(s)")
        if steps > 1:
            fail(f"step {fmt}: pools differ by {steps} steps (tol 1)")
        del out, base
    torch.cuda.empty_cache()


def _dense_step(torch, fa, cfg, params, rope, gen) -> None:
    """A 256-token prompt (prefill: flash_attn), a 128-token window at
    pos 256 (prefill_chunk: flash_attn_cached), one decode step at 384,
    flash on vs off over identical inputs."""
    import dataclasses

    from cake_tpu_torch.models.llama import model as dm
    from cake_tpu_torch.models.llama.cache import KVCache

    dev = "cuda"
    T = rope.cos.shape[0]
    prompt = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                           device=dev, dtype=torch.int32)
    window = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen,
                           device=dev, dtype=torch.int32)
    token = window[:, :1]
    out = {}
    for flash in (True, False):
        c = dataclasses.replace(cfg, use_flash_attention=flash)
        cache = KVCache.create(c, 1, T, dtype=torch.float32, device=dev)
        fa.reset_launch_counts()
        lp, _ = dm.prefill(params, prompt, torch.tensor([256], device=dev),
                           cache, rope, c)
        lc, _ = dm.prefill_chunk(params, window, 256,
                                 torch.tensor([127], device=dev), cache,
                                 rope, c)
        ld, _ = dm.decode_step(params, token, 384, cache, rope, c)
        torch.cuda.synchronize()
        out[flash] = (lp, lc, ld, cache, dict(fa.LAUNCHES))
    for flash, n in ((True, cfg.num_hidden_layers), (False, 0)):
        got = out[flash][4]
        if (got["flash_attn"], got["flash_attn_cached"]) != (n, n) or (
                got["flash_attn_plain"] or got["flash_attn_cached_plain"]):
            fail(f"step dense (flash {flash}): launches {got}, expected "
                 f"{n} of each kernel and no plain call")
    for i, what in enumerate(("prefill", "prefill_chunk", "decode_step")):
        a, b = out[True][i], out[False][i]
        err = (a - b).abs().max().item()
        log(f"step dense {what} logits: max |flash - einsum| = {err:.3e}")
        if not torch.isfinite(a).all() or err > 1e-3:
            fail(f"step dense {what}: logits differ by {err:.3e} (tol 1e-3)")
    ck, cp = out[True][3], out[False][3]
    if not (torch.equal(ck.k[0], cp.k[0]) and torch.equal(ck.v[0], cp.v[0])):
        fail("step dense: layer-0 caches differ between flash and einsum")
    cerr = max((ck.k - cp.k).abs().max().item(),
               (ck.v - cp.v).abs().max().item())
    log(f"step dense caches: layer 0 identical, max |flash - einsum| = "
        f"{cerr:.3e}")
    if cerr > 1e-4:
        fail(f"step dense: caches differ by {cerr:.3e} (tol 1e-4)")


class _plain_int4:
    """Inside the block, `int4_matmul` is its plain version even for CUDA
    tensors (the wrapper itself never takes it for one): the reference
    side of a kernel-vs-plain comparison of whole steps."""

    def __init__(self, i4):
        self.i4 = i4

    def __enter__(self):
        self.kernel = self.i4.int4_matmul
        self.i4.int4_matmul = self.i4.int4_matmul_plain

    def __exit__(self, *exc):
        self.i4.int4_matmul = self.kernel


def _int4_steps(torch, i4, cfg, params, rope, gen) -> None:
    """int4 weights at 8B width, 2 layers, f32 activations: the f32 tree
    quantized on the card by quantize_params (bits=4); a dense decode
    step and a paged decode step of 4 rows, kernel vs plain logits; then
    a 256-token prefill, whose M > 64 products take the dequantize
    route."""
    import contextlib

    from cake_tpu_torch.models.llama import model as dm
    from cake_tpu_torch.models.llama.cache import KVCache
    from cake_tpu_torch.models.llama.paged import (
        PagedKVCache, decode_step_ragged_paged, table_set_slot,
    )
    from cake_tpu_torch.ops.quant import quantize_params

    dev = "cuda"
    L = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    qparams = quantize_params(params, bits=4)
    torch.cuda.synchronize()
    log(f"step int4: quantize_params(bits=4) of the 2-layer f32 tree on the "
        f"card: peak {(torch.cuda.max_memory_allocated() - before) / 2**30:.2f}"
        f" GiB above the {before / 2**30:.2f} GiB already held")
    T = rope.cos.shape[0]
    B, P = 4, 128
    prompt = torch.randint(0, cfg.vocab_size, (1, 256), generator=gen,
                           device=dev, dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                         device=dev, dtype=torch.int32)
    pos = torch.tensor([300, 100, 5, 640], dtype=torch.int32, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    base_k = torch.randn((L, 32, P, cfg.num_key_value_heads, cfg.head_dim),
                         generator=gen, device=dev)
    base_v = torch.randn(base_k.shape, generator=gen, device=dev)
    out = {}
    for route in ("kernel", "plain"):
        ctx = _plain_int4(i4) if route == "plain" else contextlib.nullcontext()
        dense = KVCache.create(cfg, 1, T, dtype=torch.float32, device=dev)
        dense.k.normal_(generator=torch.Generator(device=dev).manual_seed(5))
        dense.v.normal_(generator=torch.Generator(device=dev).manual_seed(6))
        paged = PagedKVCache.create(cfg, B, 32, P, T, dtype=torch.float32,
                                    device=dev)
        paged.k.copy_(base_k)
        paged.v.copy_(base_v)
        for slot in range(B):
            table_set_slot(paged.table, slot,
                           list(range(slot * 8, slot * 8 + 8)))
        i4.reset_launch_counts()
        with ctx:
            ld, _ = dm.decode_step(qparams, toks[:1], 384, dense, rope, cfg)
            lp, _ = decode_step_ragged_paged(qparams, toks, pos, active,
                                             paged, rope, cfg)
        torch.cuda.synchronize()
        out[route] = (ld, lp, dict(i4.LAUNCHES))
    for route, want in (("kernel", (14 * L, 0)), ("plain", (0, 14 * L))):
        n = out[route][2]
        if (n["int4_matmul"], n["int4_matmul_plain"]) != want:
            fail(f"step int4 ({route}): launches {n}, expected {want}")
    for i, what in enumerate(("dense decode_step", "paged decode step")):
        a, b = out["kernel"][i], out["plain"][i]
        err = (a - b).abs().max().item()
        log(f"step int4 {what} logits: max |kernel - plain| = {err:.3e}")
        if not torch.isfinite(a).all() or err > 1e-3:
            fail(f"step int4 {what}: logits differ by {err:.3e} (tol 1e-3)")
    # the same weights dequantized ahead of time into plain f32 tensors:
    # the reference of the dequantize route (same function, other
    # summation order)
    from cake_tpu_torch.ops.quant import (
        QTensor, dequantize_group, is_groupwise,
    )

    def dequantized(w):
        if not isinstance(w, QTensor):
            return w
        if not is_groupwise(w):
            return w.q.float() * w.scale
        return dequantize_group(w, torch.float32)

    dq = {k: dequantized(v) for k, v in qparams.items() if k != "blocks"}
    dq["blocks"] = {k: dequantized(v) for k, v in qparams["blocks"].items()}
    logits = []
    i4.reset_launch_counts()
    for tree in (qparams, dq, params):
        cache = KVCache.create(cfg, 1, T, dtype=torch.float32, device=dev)
        lg, _ = dm.prefill(tree, prompt, torch.tensor([256], device=dev),
                           cache, rope, cfg)
        logits.append(lg)
    torch.cuda.synchronize()
    if sum(i4.LAUNCHES.values()) != 0:
        fail(f"step int4 prefill: an M = 256 product reached int4_matmul "
             f"({i4.LAUNCHES}); it takes the dequantize route")
    lq, ld, lf = logits
    err = (lq - ld).abs().max().item()
    log(f"step int4 prefill (M = 256, dequantize route): max |QTensor - "
        f"weights dequantized ahead| = {err:.3e}; against the f32 weights "
        f"the int4 rounding moves the logits by {(lq - lf).std().item():.3e}"
        f" rms (their spread {lf.std().item():.3e})")
    if not torch.isfinite(lq).all() or err > 1e-3:
        fail(f"step int4 prefill: logits differ by {err:.3e} (tol 1e-3)")
    del dq, logits
    del qparams, out, base_k, base_v
    torch.cuda.empty_cache()


# logits of the captured step against the same step run eagerly: the
# same kernels on the same inputs in the same order, so 0 is expected
GRAPH_TOL = 0.0
# the decode graph's replay ms a step and the step's bound, by (weights,
# pool), as the step phase measured them (the sched phase holds its
# decode records' HBM share against bound / replay)
GRAPH_REPLAY = {}


def _step_pool(torch, cfg, kv, B, N, P, T, gen):
    """A full-depth pool of the step phases, every page written from
    normal draws: bf16 (kv None), int8/int4 through the port's
    qwrite_prompt_pages, fp8 through its writers' cast."""
    from cake_tpu_torch.kv.quantized_pool import (
        QUANTIZED_CACHES, qwrite_prompt_pages,
    )
    from cake_tpu_torch.models.llama.paged import PagedKVCache
    from cake_tpu_torch.utils.devices import to_storage

    dev = "cuda"
    L, KV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    if kv in QUANTIZED_CACHES:
        base = QUANTIZED_CACHES[kv].create(cfg, B, N, P, T, device=dev)
        every = torch.arange(N, dtype=torch.int32, device=dev)
        for i in range(L):
            for leaf in base.layer(i):
                vals = torch.randn((1, N * P, KV, hd), generator=gen,
                                   device=dev)
                qwrite_prompt_pages(leaf, vals, every)
        return base
    dt = getattr(torch, FP8_FORMATS.get(kv, "bfloat16"))
    base = PagedKVCache.create(cfg, B, N, P, T, dtype=dt, device=dev)
    for i in range(L):
        for leaf in base.layer(i):
            leaf.copy_(to_storage(torch.randn(leaf.shape, generator=gen,
                                              device=dev), dt))
    return base


def _same_bytes(torch, a, b, pages=None) -> bool:
    """Byte equality of two pool tensors (fp8 included), or of their
    `pages` along the page axis."""
    a, b = (x.contiguous().view(torch.uint8) for x in (a, b))
    if pages is not None:
        a, b = a[:, pages], b[:, pages]
    return torch.equal(a, b)


def _graph_steps(torch, rpa, i4, cfg, params,
                 int4_weights: bool = False) -> None:
    """The engine's decode step at full width and depth: K = 4 replays of
    the captured step (`serve/graphs.DecodeRunner`) against the same
    step run 4 times eagerly, from identical pools: bf16 weights over a
    bf16, an int8 and an int4 pool, int4 weights over a bf16 pool. Eight slots of 16 pages: six live rows at ragged
    positions (one with a budget of 2, so it freezes mid-burst), one
    inactive mapped row, one unmapped. Greedy tokens must be identical,
    the real pages byte-identical and the last step's logits within
    GRAPH_TOL; each side launches 4 x L decode kernels (7 x 4 x L int4
    products with int4 weights) and no plain version."""
    import functools

    import numpy as np

    from cake_tpu_torch.models.llama.model import RopeTables
    from cake_tpu_torch.models.llama.paged import (
        forward_ragged_paged, table_set_slot,
    )
    from cake_tpu_torch.serve.graphs import DecodeRunner

    dev = "cuda"
    B, P, T, N, K = 8, 128, 2048, 128, 4
    L, KV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(11)
    rope = RopeTables.create(cfg, T, device=dev)
    pos = np.array([100, 400, 1000, 1500, 129, 7, 300, 0])
    live = np.array([True] * 6 + [False, False])
    budget = np.array([K, K, K, K, 2, K, K, K])
    toks = np.arange(B) * 1009 % cfg.vocab_size
    label = "int4 weights" if int4_weights else "bf16 weights"
    for kv in ((None,) if int4_weights else (None, "int8", "int4")
               + (("f8_e4m3",) if hasattr(rpa, "_FP8_SUFFIX") else ())):
        base = _step_pool(torch, cfg, kv, B, N, P, T, gen)
        for b in range(B - 1):                  # slot 7: every page unmapped
            table_set_slot(base.table, b, list(range(16 * b, 16 * b + 16)))
        runs = {}
        for mode in ("graph", "eager"):
            cache = base.clone()
            runner = DecodeRunner(
                params, cache, rope, cfg,
                forward_fn=functools.partial(forward_ragged_paged,
                                             attn="kernel"),
                ring=torch.full((B, 128), -1, dtype=torch.int64, device=dev),
                seeds=torch.arange(B, device=dev),
                counters=torch.zeros(B, dtype=torch.int64, device=dev),
                max_steps=K, n_top_cap=20, top_k=None)
            runner.load(0, toks, pos, live, np.zeros(B, np.int64),
                        np.zeros(B, np.float32), np.ones(B, np.float32),
                        np.full(B, 1.1, np.float32))
            torch.cuda.synchronize()
            rpa.reset_launch_counts()
            i4.reset_launch_counts()
            if mode == "graph":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                handle = runner.run(K, budget, 0)
                b.record()
                out = DecodeRunner.fetch(handle)[0]
                ms = a.elapsed_time(b) / K
            else:
                runner.begin(budget)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(K):
                    runner.step(0)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / K
                out = runner.out[0][:, :K].cpu().numpy()
            counts = {**rpa.LAUNCHES, **i4.LAUNCHES}
            runs[mode] = (out, runner.logits.clone(), cache, counts, ms)
            del runner
        (tg, lg, cg, ng, ms_g), (te, le, ce, ne, ms_e) = (runs["graph"],
                                                          runs["eager"])
        name = f"{label}, {kv or 'bf16'} pool"
        if kv in (None, "f8_e4m3"):
            # the pool's bytes a token at its stored size: 2 bf16, 1 fp8
            bound = _mixed_step_bound(
                cfg, params, B, 1, pos, live.astype(int),
                2 * L * KV * hd * (1 if kv else 2))[0]
            GRAPH_REPLAY[label if kv is None else f"{label}, {kv}"] = (
                ms_g, bound)
            log(f"step graph ({name}): a decode step's bound {bound:.3f} "
                f"ms (bytes), the replay {bound / ms_g:.3f} of it")
        rows = torch.as_tensor(np.flatnonzero(live & (budget == K)),
                               device=dev)
        err = (lg[rows] - le[rows]).abs().max().item()
        log(f"step graph ({name}): {K} replays {ms_g:.3f} ms a step "
            f"(device, CUDA events), eager step {ms_e:.3f} ms (host, "
            f"synchronized); tokens {tg[live].tolist()}; last step's logits "
            f"max |graph - eager| = {err:.3e} (tol {GRAPH_TOL})")
        if not np.array_equal(tg, te):
            fail(f"step graph ({name}): tokens differ:\n{tg}\n{te}")
        if not torch.isfinite(lg[rows]).all() or err > GRAPH_TOL:
            fail(f"step graph ({name}): logits differ by {err:.3e}")
        pages = ((cg.k, ce.k), (cg.v, ce.v))
        if kv in ("int8", "int4"):
            pages = tuple((x, y) for a, b in pages for x, y in zip(a, b))
        if not all(_same_bytes(torch, x, y) for x, y in pages):
            fail(f"step graph ({name}): the written pages differ")
        suffix = _kernel_suffix(kv)
        want = {"rpa_decode" + suffix: K * L}
        if int4_weights:
            want["int4_matmul"] = 7 * K * L
        for mode, n in (("graph", ng), ("eager", ne)):
            got = {k: n[k] for k in want}
            plain = {k: v for k, v in n.items() if k.endswith("_plain") and v}
            if got != want or plain:
                fail(f"step graph ({name}, {mode}): launches {got}, plain "
                     f"{plain}; expected {want} and no plain call")
        del runs, base, cg, ce
        torch.cuda.empty_cache()


def _mixed_step_bound(cfg, params, B, C, pos, q_len, kv_bytes_per_token):
    """(bound ms, what bounds it, ms at all B x C columns) of one mixed
    step: the larger of the bytes it must move over HBM_BYTES_PER_S
    (every weight read once but the embedding, of which the step gathers
    B x C rows; each row's KV history read once) and its operations over
    the bf16 peak: 2 x (matmul weights) per real token (sum(q_len)), the
    lm_head's 2 x D x V per row, and 4 x H x hd per (query, key) pair of
    the attention."""
    import torch

    def nbytes(t):
        if isinstance(t, dict):
            return sum(nbytes(v) for v in t.values())
        if isinstance(t, torch.Tensor):
            return t.numel() * t.element_size()
        return sum(nbytes(x) for x in t)        # a QTensor's (q, scale)

    D, H, KV, hd = (cfg.hidden_size, cfg.num_attention_heads,
                    cfg.num_key_value_heads, cfg.head_dim)
    L, F, V = cfg.num_hidden_layers, cfg.intermediate_size, cfg.vocab_size
    embed = params["embed"]
    weights = nbytes(params) - nbytes(embed) + B * C * D * embed.element_size()
    kv = sum(int(p) + int(n) for p, n in zip(pos, q_len) if n) \
        * kv_bytes_per_token
    per_token = L * (2 * D * H * hd + 2 * D * KV * hd + 3 * D * F)
    pairs = sum(n * p + n * (n + 1) // 2 for p, n in zip(pos, q_len))
    attn = 4 * H * hd * L

    def ops(tokens, qk_pairs):
        return 2 * per_token * tokens + 2 * B * D * V + attn * qk_pairs

    t_bytes = (weights + kv) / HBM_BYTES_PER_S * 1e3
    t_ops = ops(int(sum(q_len)), pairs) / PEAK_OPS["bfloat16"] * 1e3
    all_cols = sum(C * p + C * (C + 1) // 2 for p in pos)
    t_all = max(t_bytes,
                ops(B * C, all_cols) / PEAK_OPS["bfloat16"] * 1e3)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", t_all)


def _window_writer_ms(torch, cache, pos, q_len, active, C, KV,
                      hd) -> float:
    """Device ms of one layer's k-leaf window write at the step's rows
    (`write_windows_pages` through the step's fixed-shape targets),
    from a CUDA graph of 30 calls, replayed."""
    from cake_tpu_torch.models.llama.paged import (
        step_write_targets, write_windows_pages,
    )

    tg = step_write_targets(cache, pos, active, q_len, C)
    vals = torch.randn((len(pos), C, KV, hd), device="cuda",
                       dtype=torch.bfloat16)
    pk, pv = cache.layer(0)

    def one():
        write_windows_pages(pk, pv, vals, vals, pos, q_len, active,
                            cache.table, tg)

    # a call writes both halves: half of it is one leaf's
    return _stream_ms(torch, [one])[0] / 2


def _mixed_graph_steps(torch, rpa, i4, cfg, params,
                       int4_weights: bool = False) -> None:
    """The engine's mixed step at full width and depth: 4 replays of the
    captured step (`serve/graphs.MixedRunner`) against the same 4 steps
    run eagerly, from identical pools: bf16 weights over a bf16, an int8
    and an int4 pool, int4 weights over a bf16 pool. B = 8, C = 64,
    128-token pages: decode rows (one on an unmapped page), chunk rows at
    in-page offsets (one of 37 real tokens), a chunk row after two
    shared prefix pages (which a decode row maps too), an idle row; the
    decode rows emit every step, the chunk rows at the last. Greedy
    tokens must be identical, the real pages byte-identical, the shared
    pages (and scales) unchanged, the logits of the active rows within
    GRAPH_TOL; each side launches 4 x L mixed-attention kernels and no
    plain version (int4 weights: no int4_matmul either, as the block
    products have B x C = 512 rows and take the dequantize route and the
    lm_head is int8). Prints a replay's device ms beside the step's bound
    and the eager step's host ms, and each quantized pool's window writer
    device time a layer."""
    import numpy as np

    from cake_tpu_torch.models.llama.model import RopeTables
    from cake_tpu_torch.models.llama.paged import table_set_slot
    from cake_tpu_torch.serve.graphs import MixedRunner

    dev = "cuda"
    B, C, P, T, N, K = 8, 64, 128, 2048, 128, 4
    L, KV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(12)
    rope = RopeTables.create(cfg, T, device=dev)
    shared = [126, 127]
    tables = [list(range(16 * b, 16 * b + 16)) for b in range(B)]
    tables[4] = shared + tables[4][2:]          # a chunk after the prefix
    tables[5] = shared + tables[5][2:]          # a decode row on it too
    tables[7] = [112, -1]                       # its page 1 unmapped
    pos0 = np.array([1000, 129, 100, 300, 256, 700, 0, 200])
    q_len = np.array([1, 1, 64, 37, 64, 1, 0, 1])
    active = q_len > 0
    decode = q_len == 1
    rng = np.random.default_rng(12)
    steps = []
    for k in range(K):
        tokens = rng.integers(0, cfg.vocab_size, size=(B, C))
        pos = pos0 + k * q_len
        emit = decode | (active & (k == K - 1))
        steps.append((tokens, pos, q_len, active, emit,
                      np.full(B, k, np.int64), np.zeros(B, np.float32),
                      np.ones(B, np.float32), np.full(B, 1.1, np.float32)))
    label = "int4 weights" if int4_weights else "bf16 weights"
    for kv in ((None,) if int4_weights else (None, "int8", "int4")
               + (("f8_e4m3",) if hasattr(rpa, "_FP8_SUFFIX") else ())):
        base = _step_pool(torch, cfg, kv, B, N, P, T, gen)
        for b in range(B):
            table_set_slot(base.table, b, tables[b])
        torch.cuda.synchronize()
        runs = {}
        for mode in ("graph", "eager"):
            cache = base.clone()
            runner = MixedRunner(
                params, cache, rope, cfg, attn="kernel",
                ring=torch.full((B, 128), -1, dtype=torch.int64, device=dev),
                seeds=torch.arange(B, device=dev),
                counters=torch.zeros(B, dtype=torch.int64, device=dev),
                chunk=C, n_top_cap=20, top_k=None)
            runner.captured(0)
            torch.cuda.synchronize()
            rpa.reset_launch_counts()
            i4.reset_launch_counts()
            toks, logits, ms = [], [], []
            for rows in steps:
                runner.load(0, *rows)
                if mode == "graph":
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    runner.replay(0)
                    b.record()
                    out = MixedRunner.fetch(runner.download(1, 0))[0][:, 0]
                    ms.append(a.elapsed_time(b))
                else:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    runner.step(0)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    out = runner.out[0][:, 0].clone().cpu().numpy()
                toks.append(out)
                logits.append(runner.logits.clone())
            counts = {**rpa.LAUNCHES, **i4.LAUNCHES}
            runs[mode] = (np.stack(toks), logits, cache, counts,
                          statistics.median(ms))
            del runner
        (tg, lg, cg, ng, ms_g), (te, le, ce, ne, ms_e) = (runs["graph"],
                                                          runs["eager"])
        name = f"{label}, {kv or 'bf16'} pool"
        rows = torch.as_tensor(np.flatnonzero(active), device=dev)
        err = max((a[rows] - b[rows]).abs().max().item()
                  for a, b in zip(lg, le))
        kv_token = (2 * L * KV * hd
                    * {"int8": 1.0, "int4": 0.5, "f8_e4m3": 1.0}.get(kv, 2.0))
        bound, by, bound_all = _mixed_step_bound(
            cfg, params, B, C, steps[0][1], q_len, kv_token)
        log(f"mixed graph ({name}): {K} replays, {ms_g:.3f} ms a step "
            f"(device, CUDA events, median), bound {bound:.3f} ms "
            f"({by}; {bound_all:.3f} ms at all {B} x {C} columns), eager "
            f"step {ms_e:.3f} ms (host, synchronized); emitted tokens "
            f"{[t[e].tolist() for t, e in zip(tg, (s[4] for s in steps))]}"
            f"; logits max |graph - eager| = {err:.3e} (tol {GRAPH_TOL})")
        emitted = np.stack([s[4] for s in steps])
        if not np.array_equal(tg[emitted], te[emitted]):
            fail(f"mixed graph ({name}): tokens differ:\n{tg}\n{te}")
        if not all(torch.isfinite(x[rows]).all() for x in lg) or \
                err > GRAPH_TOL:
            fail(f"mixed graph ({name}): logits differ by {err:.3e}")
        halves = ((cg.k, ce.k, base.k), (cg.v, ce.v, base.v))
        if kv in ("int8", "int4"):
            halves = tuple(z for h in halves for z in zip(*h))
        if not all(_same_bytes(torch, x, y) for x, y, _ in halves):
            fail(f"mixed graph ({name}): the written pages differ")
        if not all(_same_bytes(torch, x, z, shared) for x, _, z in halves):
            fail(f"mixed graph ({name}): a shared prefix page was written")
        suffix = _kernel_suffix(kv)
        want = {"rpa_mixed" + suffix: K * L, "int4_matmul": 0}
        for mode, n in (("graph", ng), ("eager", ne)):
            got = {k: n.get(k, 0) for k in want}
            plain = {k: v for k, v in n.items() if k.endswith("_plain") and v}
            if got != want or plain:
                fail(f"mixed graph ({name}, {mode}): launches {got}, plain "
                     f"{plain}; expected {want} and no plain call")
        wms = _window_writer_ms(torch, ce, *(torch.as_tensor(
            x, device=dev) for x in (steps[0][1], q_len, active)), C,
            KV, hd)
        log(f"mixed graph ({name}): the fixed-shape window writer, "
            f"{B} rows x {-(-C // P) + 1} pages: {wms:.4f} ms a layer's "
            f"k or v leaf (device, a CUDA graph of 30 calls)")
        del runs, base, cg, ce
        torch.cuda.empty_cache()


# -- phase: serve -------------------------------------------------------------


def _post(url, body, timeout=600):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


_PORT_KERNEL = re.compile(r"\(anonymous namespace\)::(rpa_|flash_|int4_)")


def _device_time_table(prof, wall_s: float, top: int = 12) -> list:
    """Print the kernels that took the most device time in a profiled
    window, then the port's own kernels (csrc/) ranked below them, and
    the device's busy share of the window's wall time. Only
    kernel rows count: an operator row (aten::mm, ...) carries the time
    of the kernels it launched again."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t, e.count, e.key))
    busy = sum(t for t, _, _ in rows) / 1e3
    log(f"profile: device busy {busy:.1f} ms of {wall_s * 1e3:.1f} ms wall "
        f"({100 * busy / max(wall_s * 1e3, 1e-9):.1f}% busy)")
    for i, (t, n, name) in enumerate(sorted(rows, reverse=True)):
        if i < top or _PORT_KERNEL.search(name):
            log(f"profile: {t / 1e3:10.2f} ms "
                f"{100 * t / 1e3 / max(busy, 1e-9):5.1f}% {n:7d}x {name[:90]}")
    return rows


def _big_params(torch):
    """Llama-3-8B width and depth, random bf16 weights from a seed, made
    once for the generate and serve phases."""
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.params import init_params

    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"32-layer 8B-width bf16 params on the card in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
    return cfg, params


def _profiled(torch, profile: bool, label: str, fn, rows=None):
    """fn() under torch.profiler when asked (printing where the device
    time went, and appending its (device us, count, kernel) rows to
    `rows`); returns fn's result."""
    if not profile:
        return fn()
    from torch.profiler import ProfilerActivity
    prof = torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    with prof:
        out = fn()
        torch.cuda.synchronize()
    log(f"profile of {label}:")
    table = _device_time_table(prof, time.perf_counter() - t0)
    if rows is not None:
        rows.extend(table)
    return out


def _prompt_of(tokenizer, n_tokens: int, system: str) -> str:
    """A user message whose chat rendering (Llama-3 template, with the
    system message) encodes to exactly n_tokens byte tokens."""
    from cake_tpu_torch.models.chat import History, Message

    h = History("llama3")
    h.add_message(Message.system(system))
    h.add_message(Message.user(""))
    overhead = len(tokenizer.encode(h.render()))
    if n_tokens < overhead:
        fail(f"a {n_tokens}-token prompt is shorter than its template "
             f"({overhead} tokens)")
    words = " ".join(f"w{i}" for i in range(n_tokens))
    return words[:n_tokens - overhead]


def phase_generate(torch, fa, cfg, params, profile: bool = False) -> dict:
    """The slice's path: Master.generate_text over the sequential
    generator at full width and depth, bf16, greedy. Run A: a prompt of
    1000 tokens, bucket 1024 (one flash_attn per layer). Run B: 1500
    tokens in 256-token windows (six flash_attn_cached per layer). The
    phase's command lines (`_generate_cli`) run apart: main starts them
    while dense (a)'s identity drives run (the time budget)."""
    import dataclasses

    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.chat import Message
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.ops.sampling import SamplingConfig

    dev = "cuda"
    fcfg = dataclasses.replace(cfg, use_flash_attention=True)
    tok = ByteTokenizer(cfg.vocab_size)
    system = "You are a helpful AI assistant."
    n_new = 32

    def master(prefill_chunk=None):
        gen = LlamaGenerator(fcfg, params, tok, max_seq_len=4096,
                             sampling=SamplingConfig(temperature=0.0),
                             cache_dtype=torch.bfloat16,
                             prefill_chunk=prefill_chunk, device=dev)
        return Master(Args(sample_len=n_new, system_prompt=system),
                      text_generator=gen)

    def run(m, n_prompt, prefill_label=None):
        g = m.llm
        m.add_message(Message.system(system))
        m.add_message(Message.user(_prompt_of(tok, n_prompt, system)))
        timing = {}
        prefill_prompt = g._prefill_prompt

        def timed_prefill():
            t0 = time.perf_counter()
            logits = prefill_prompt()
            torch.cuda.synchronize()
            timing["prefill_s"] = time.perf_counter() - t0
            return logits

        g._prefill_prompt = timed_prefill if prefill_label is None else \
            (lambda: _profiled(torch, profile, prefill_label, timed_prefill))
        t0 = time.perf_counter()

        def on_token(t):
            timing.setdefault("ttft_s", time.perf_counter() - t0)

        m.generate_text(on_token)
        torch.cuda.synchronize()
        timing.update(prompt=g._prompt_len, tokens=len(g.tokens),
                      tok_s=m.tokens_per_s, wall_s=time.perf_counter() - t0,
                      eos=g.tokens[-1] in cfg.eos_token_ids)
        return timing

    # warm-up: cuBLAS handles, the kernel library and the generator's
    # captured decode step, off the counts; run A then reuses the
    # generator (reset in place), so its decode time is replays alone
    m_a = master()
    run(m_a, 300)
    m_a.reset()
    fa.reset_launch_counts()
    rows_a = []
    a = _profiled(torch, profile, "generate run A",
                  lambda: run(m_a, 1000), rows_a)
    if rows_a:
        # over the run's own wall (the profiler's teardown left out)
        a["busy"] = sum(t for t, _, _ in rows_a) / 1e6 / a["wall_s"]
    counts_a = dict(fa.LAUNCHES)
    b = run(master(prefill_chunk=256), 1500, "generate run B's prefill")
    counts = dict(fa.LAUNCHES)
    L = cfg.num_hidden_layers
    for label, t in (("A (bucket 1024)", a), ("B (256-token windows)", b)):
        log(f"generate {label}: prompt {t['prompt']} tokens, TTFT "
            f"{t['ttft_s']:.3f} s, prefill {t['prefill_s']:.3f} s, "
            f"{t['tokens']} tokens, decode {t['tok_s']:.1f} tok/s"
            + (f", device busy {100 * t['busy']:.1f}%" if "busy" in t
               else ""))
        if t["tokens"] != n_new and not t["eos"]:
            fail(f"generate {label}: {t['tokens']} tokens, expected {n_new}")
    log(f"generate: launches {counts} (after run A: {counts_a})")
    if hasattr(fa, "flash_split_plan"):
        splits = fa.flash_split_plan(
            1, 256, 4096, cfg.num_attention_heads, cfg.num_key_value_heads,
            fa.device_sm_count("cuda"), fa.CACHED_WARPS)
        log(f"generate B: flash_attn_cached over bf16 runs the tensor-core "
            f"body at {fa.CACHED_WARPS} warps a CTA, {splits} key splits "
            "a 256-token window")
    want = {"flash_attn": L, "flash_attn_cached": 6 * L,
            "flash_attn_plain": 0, "flash_attn_cached_plain": 0}
    if counts != want or counts_a["flash_attn_cached"] != 0:
        fail(f"generate: launches {counts}, expected {want}")

    if hasattr(LlamaGenerator, "_decode_runner"):
        _generator_graph(torch, fcfg, params, tok, system)
    return counts


def _generate_cli():
    """The generate phase's two command lines, each in its own process on
    the card: the checkpoint directory's with --batch-size 2 and
    --tracing DIR (`_checkpoint_cli`) and the tiny model's with --quant
    int4 (`_quant_cli`). Returns, once both are started, the function
    that joins and checks them: main runs untimed drives meanwhile (dense
    (a)'s identities)."""
    import tempfile
    trace_dir = tempfile.mkdtemp(prefix="cake_smoke_trace_")
    joins = [_checkpoint_cli(["--batch-size", "2", "--tracing", trace_dir],
                             trace_dir), _quant_cli()]
    return lambda: [join() for join in joins]


# the small checkpoint directory the generate phase writes and loads:
# Llama-3's special tokens (their ids follow the merges), a small width
CKPT_SPECIALS = ("<|begin_of_text|>", "<|end_of_text|>",
                 "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>")
CKPT_MERGES = 300
CKPT_CONFIG = dict(
    model_type="llama", hidden_size=256, intermediate_size=512,
    num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
    rms_norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=1024,
    tie_word_embeddings=False, vocab_size=640)
CKPT_ROUND_TRIP = "Grüße, 東京! Привет мир ١٢٣ 😀 naïve café\r\n\tx"
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                r"|\s+(?!\S)|\s+")


def _bpe_merges(corpus: str, n: int, b2u) -> list:
    """n byte-level BPE merges learned from `corpus` (whitespace-split
    words, the most frequent adjacent pair merged first): enough to make
    a tokenizer.json of the Llama-3 kind without the tokenizers package."""
    words = Counter()
    for w in re.findall(r" ?\S+", corpus):
        words[tuple(b2u[b] for b in w.encode("utf-8"))] += 1
    merges = []
    while len(merges) < n:
        pairs = Counter()
        for w, c in words.items():
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] += c
        if not pairs:
            break
        (a, b), _ = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        merges.append((a, b))
        nxt = Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            nxt[tuple(out)] += c
        words = nxt
    return merges


def _tokenizer_json():
    """(spec, specials): a byte-level BPE tokenizer.json of the Llama-3
    kind (256 byte tokens, CKPT_MERGES merges learned from this file's
    docstring, Llama-3's special tokens and split, the
    <|begin_of_text|> template) and its special tokens' ids."""
    from cake_tpu_torch.models.llama.tokenizer import bytes_to_unicode

    b2u = bytes_to_unicode()
    vocab = {b2u[b]: b for b in range(256)}
    merges = _bpe_merges(__doc__, CKPT_MERGES, b2u)
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    specials = {t: len(vocab) + i for i, t in enumerate(CKPT_SPECIALS)}
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [dict(id=i, content=t, single_word=False,
                              lstrip=False, rstrip=False, normalized=False,
                              special=True) for t, i in specials.items()],
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": {"type": "TemplateProcessing", "single": [
            {"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 0}},
            {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [], "special_tokens": {"<|begin_of_text|>": {
                "id": "<|begin_of_text|>",
                "ids": [specials["<|begin_of_text|>"]],
                "tokens": ["<|begin_of_text|>"]}}},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]},
    }
    return spec, specials


def _write_checkpoint(dirname: str, seed: int = 0) -> dict:
    """A small Llama checkpoint directory written by hand: config.json, a
    model.safetensors of random f32 weights from `seed` (the header JSON
    and the raw bytes: the card has no safetensors package) and a
    byte-level BPE tokenizer.json (256 byte tokens, CKPT_MERGES merges
    learned from this file's docstring, Llama-3's special tokens and
    split, the <|begin_of_text|> template). Returns the config."""
    import numpy as np

    spec, specials = _tokenizer_json()
    cfg = dict(CKPT_CONFIG, bos_token_id=specials["<|begin_of_text|>"],
               eos_token_id=[specials["<|end_of_text|>"],
                             specials["<|eot_id|>"]])
    if max(specials.values()) >= cfg["vocab_size"]:
        fail(f"checkpoint: {max(specials.values()) + 1} tokens past the "
             f"vocabulary of {cfg['vocab_size']}")
    D, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = D // H
    rng = np.random.default_rng(seed)
    tensors = {"model.embed_tokens.weight": (V, D), "lm_head.weight": (V, D),
               "model.norm.weight": (D,)}
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        tensors.update({
            pre + "self_attn.q_proj.weight": (H * hd, D),
            pre + "self_attn.k_proj.weight": (KV * hd, D),
            pre + "self_attn.v_proj.weight": (KV * hd, D),
            pre + "self_attn.o_proj.weight": (D, H * hd),
            pre + "mlp.gate_proj.weight": (F, D),
            pre + "mlp.up_proj.weight": (F, D),
            pre + "mlp.down_proj.weight": (D, F),
            pre + "input_layernorm.weight": (D,),
            pre + "post_attention_layernorm.weight": (D,)})
    header, blobs, off = {}, [], 0
    for name, shape in tensors.items():
        a = (np.ones(shape, np.float32) if name.endswith("norm.weight")
             else rng.standard_normal(shape).astype(np.float32) * 0.05)
        raw = a.tobytes()
        header[name] = {"dtype": "F32", "shape": list(shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, "model.safetensors"), "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    with open(os.path.join(dirname, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(dirname, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    return cfg


def _checkpoint_cli(extra, trace_dir):
    """The load path of a real checkpoint on the card: a small checkpoint
    directory (`_write_checkpoint`) read through the port's tokenizer.json
    reader (the round trip of a mixed-script string printed and
    required), then `python -m cake_tpu_torch.cli --model DIR` and the
    flags `extra` (--tracing trace_dir among them) in its own process.
    Returns, once the child is started, the function that joins it and
    requires exit 0 and exactly one trace file in trace_dir."""
    import tempfile

    from cake_tpu_torch.models.llama.generator import load_tokenizer
    from cake_tpu_torch.models.llama.tokenizer import BpeTokenizer

    d = tempfile.mkdtemp(prefix="cake_smoke_ckpt_")
    cfg = _write_checkpoint(d)
    tok = load_tokenizer(d)
    ids = tok.encode(CKPT_ROUND_TRIP)
    back = tok.decode(ids)
    log(f"checkpoint: {d} ({CKPT_MERGES} merges, vocab {cfg['vocab_size']},"
        f" {type(tok).__name__}); {CKPT_ROUND_TRIP!r} -> {len(ids)} ids "
        f"{ids[:12]}... -> {back!r}")
    english = tok.encode("Why is the sky blue?", add_special_tokens=False)
    if not isinstance(tok, BpeTokenizer) or back != CKPT_ROUND_TRIP \
            or ids[0] != cfg["bos_token_id"] or len(english) >= 20:
        fail(f"checkpoint: the tokenizer.json round trip failed "
             f"({len(english)} ids for 20 English bytes)")
    cmd = [sys.executable, "-m", "cake_tpu_torch.cli", "--model", d,
           "--prompt", "Why is the sky blue?", "--sample-len", "8",
           *extra]
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd, cwd=sys.path[0], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    return lambda: _checkpoint_cli_end(child, cmd, t0, trace_dir, d, ids,
                                       back)


def _checkpoint_cli_end(child, cmd, t0, trace_dir, d, ids, back) -> dict:
    """_checkpoint_cli's child joined: its exit, its trace file."""
    try:
        stdout, stderr = child.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        child.kill()
        fail("checkpoint: the command line ran past 600 s")
    r = subprocess.CompletedProcess(cmd, child.returncode, stdout, stderr)
    traces = sorted(f for f in os.listdir(trace_dir) if f.endswith(".json"))
    log(f"checkpoint: `{' '.join(cmd[1:])}` exit {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; stdout tail "
        f"{r.stdout.strip().splitlines()[-1:]!r}; trace files {traces}")
    if r.returncode != 0:
        fail(f"checkpoint: the command line failed:\n{r.stderr[-3000:]}")
    reader = re.search(r"tensors from \d+ file\(s\) through the "
                       r"(native reader|numpy memmap)", r.stderr)
    _NATIVE.update(ckpt_dir=d, ckpt_reader=reader and reader.group(1))
    if len(traces) != 1:
        fail(f"checkpoint: --tracing {trace_dir} wrote {traces}")
    return dict(dir=d, ids=len(ids), round_trip=back == CKPT_ROUND_TRIP,
                cli_exit=r.returncode)


def _generator_graph(torch, fcfg, params, tok, system) -> None:
    """The generator's captured decode step (serve/graphs.GeneratorRunner)
    at full width and depth, bf16, greedy: from one 1000-token prefill,
    8 steps run eagerly (`step`), then from the same caches and carry 8
    replays of the captured step: identical tokens and logits, each
    replay's device ms (CUDA events) beside the eager step's host ms.
    Then generate_on_device at B = 1 and 4 against next_token's greedy
    stream of 16 tokens with flash off (the scan's prefill is the masked
    einsum): B = 1 identical, B = 4's rows equal to one another (their
    agreement with the stream printed: a batched GEMM rounds apart)."""
    import dataclasses

    import numpy as np

    from cake_tpu_torch.models.chat import Message
    from cake_tpu_torch.models.llama.generator import (
        LlamaGenerator, bucket_length, encode_text,
    )
    from cake_tpu_torch.ops.sampling import SamplingConfig

    gen = LlamaGenerator(fcfg, params, tok, max_seq_len=4096,
                         sampling=SamplingConfig(temperature=0.0),
                         cache_dtype=torch.bfloat16, device=DEV)
    gen.add_message(Message.system(system))
    gen.add_message(Message.user(_prompt_of(tok, 1000, system)))
    gen.next_token(0)
    r = gen._decode
    keep = (gen.cache.k, gen.cache.v, r.tok, r.pos, r.steps, r.col,
            r.counters, r.ring)
    saved = [t.clone() for t in keep]
    eager, host_ms = [], []
    for _ in range(8):
        t0 = time.perf_counter()
        r.step(None)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        eager.append((r.tok.clone(), r.logits.clone()))
    r.captured(None)                  # capture (the warm-up restores)
    for t, v in zip(keep, saved):
        t.copy_(v)
    del saved
    dev_ms, err = [], 0.0
    for i in range(8):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        r.replay(None)
        e1.record()
        e1.synchronize()
        dev_ms.append(e0.elapsed_time(e1))
        if not torch.equal(r.tok, eager[i][0]):
            fail(f"generate graph: replay {i} sampled {r.tok.tolist()}, "
                 f"the eager step {eager[i][0].tolist()}")
        err = max(err, (r.logits - eager[i][1]).abs().max().item())
    log(f"generate graph: 8 replays of the captured decode step (32 "
        f"layers, bf16, 4096-slot cache) against 8 eager steps: tokens "
        f"identical, logits max |replay - eager| {err:.3e}; replay device "
        f"{statistics.median(dev_ms):.3f} ms (median), eager step host "
        f"{statistics.median(host_ms):.3f} ms; {r.captures} capture")
    if err != 0.0:
        fail(f"generate graph: replayed logits differ from the eager "
             f"step's by {err:.3e}")
    del gen, r, eager, keep
    torch.cuda.empty_cache()

    ncfg = dataclasses.replace(fcfg, use_flash_attention=False)
    gen = LlamaGenerator(ncfg, params, tok, max_seq_len=2048,
                         sampling=SamplingConfig(temperature=0.0),
                         cache_dtype=torch.bfloat16, device=DEV)
    gen.add_message(Message.system(system))
    gen.add_message(Message.user(_prompt_of(tok, 300, system)))
    stream = [gen.next_token(i).id for i in range(16)]
    ids = encode_text(tok, gen.history.render())
    bucket = bucket_length(len(ids), 2048)     # next_token's prefill's
    padded = np.array(ids + [0] * (bucket - len(ids)))
    for B in (1, 4):
        walls = []
        for _ in range(2):        # the first call captures the B-row step
            t0 = time.perf_counter()
            out = gen.generate_on_device(np.stack([padded] * B),
                                         np.full(B, len(ids)), 16)
            walls.append(time.perf_counter() - t0)
        agree = [int(np.argmin(np.append(row == np.array(stream), False)))
                 for row in out]
        log(f"generate_on_device B={B}: 16 tokens in {walls[1]:.3f} s "
            f"(one eager prefill, 15 replays, one fetch; "
            f"{B * 16 / walls[1]:.1f} tok/s; the first call, capture "
            f"included, {walls[0]:.3f} s), rows agree with next_token's "
            f"stream for {agree} tokens")
        if B == 1 and agree != [16]:
            fail(f"generate_on_device B=1: {out[0].tolist()} against "
                 f"next_token's {stream}")
        if not (out == out[0]).all():
            fail(f"generate_on_device B={B}: the rows differ: {out}")
    del gen
    torch.cuda.empty_cache()


def phase_generate_quant(torch, i4, cfg) -> dict:
    """The weight-quantized path: Master.generate_text over 32-layer
    8B-width int4 weights (init_params_quantized, bits=4), a 300-token
    prompt (prefill: the dequantize route) and 32 greedy tokens (decode:
    7 int4_matmul launches per layer and step, no plain call); the same
    with int8 weights for 4 tokens (the command line with --quant int4
    runs apart: `_quant_cli`). Returns the int4 params and the int4
    run's launch counts."""
    import dataclasses

    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.chat import Message
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.models.llama.params import (
        init_params_quantized, params_bytes,
    )
    from cake_tpu_torch.ops.sampling import SamplingConfig

    dev = "cuda"
    fcfg = dataclasses.replace(cfg, use_flash_attention=True)
    tok = ByteTokenizer(cfg.vocab_size)
    system = "You are a helpful AI assistant."
    L = cfg.num_hidden_layers

    def generator(params):
        return LlamaGenerator(fcfg, params, tok, max_seq_len=4096,
                              sampling=SamplingConfig(temperature=0.0),
                              cache_dtype=torch.bfloat16, device=dev)

    def run(gen, quant, n_new):
        gen.reset()
        m = Master(Args(sample_len=n_new, system_prompt=system, quant=quant),
                   text_generator=gen)
        m.add_message(Message.system(system))
        m.add_message(Message.user(_prompt_of(tok, 300, system)))
        t0 = time.perf_counter()
        timing = {}
        m.generate_text(
            lambda t: timing.setdefault("ttft_s", time.perf_counter() - t0))
        torch.cuda.synchronize()
        g = m.llm
        timing.update(prompt=g._prompt_len, tokens=len(g.tokens),
                      tok_s=m.tokens_per_s,
                      eos=g.tokens[-1] in cfg.eos_token_ids)
        return timing

    def made(bits):
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = init_params_quantized(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
            dtype=torch.bfloat16, bits=bits)
        torch.cuda.synchronize()
        log(f"generate int{bits}: 32-layer 8B-width params on the card in "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{params_bytes(params) / 2**30:.3f} GiB of tensors, peak "
            f"{(torch.cuda.max_memory_allocated() - before) / 2**30:.3f} GiB "
            "while making them")
        return params

    q4 = made(4)
    gen4 = generator(q4)
    run(gen4, "int4", 4)          # warm-up and capture, off the counts
    i4.reset_launch_counts()
    t = run(gen4, "int4", 32)
    counts = dict(i4.LAUNCHES)
    log(f"generate int4: prompt {t['prompt']} tokens, TTFT {t['ttft_s']:.3f} "
        f"s, {t['tokens']} tokens, decode {t['tok_s']:.1f} tok/s; launches "
        f"{counts}")
    if t["tokens"] != 32 and not t["eos"]:
        fail(f"generate int4: {t['tokens']} tokens, expected 32")
    # token 1 comes from the prefill (M = its bucket > 64: the dequantize
    # route), every later one from a decode step
    want = 7 * L * (t["tokens"] - 1)
    if counts != {"int4_matmul": want, "int4_matmul_plain": 0}:
        fail(f"generate int4: launches {counts}, expected {want} (7 x {L} "
             "per decode step) and no plain call")

    del gen4
    q8 = made(8)
    i4.reset_launch_counts()
    t8 = run(generator(q8), "int8", 4)
    log(f"generate int8: prompt {t8['prompt']} tokens, TTFT "
        f"{t8['ttft_s']:.3f} s, {t8['tokens']} tokens, decode "
        f"{t8['tok_s']:.1f} tok/s (plain PyTorch: each weight is converted "
        "to the activation dtype before its product)")
    if t8["tokens"] != 4 and not t8["eos"]:
        fail(f"generate int8: {t8['tokens']} tokens, expected 4")
    if sum(i4.LAUNCHES.values()) != 0:
        fail(f"generate int8: int4_matmul ran ({i4.LAUNCHES})")
    del q8
    torch.cuda.empty_cache()
    return q4, counts


def _quant_cli():
    """The command line with --quant int4 in its own process (the tiny
    model: context._maybe_quantize and the gate's small shapes on the
    card). Returns, once the child is started, the function that joins
    it and requires exit 0 and the quantization's log line."""
    cmd = [sys.executable, "-m", "cake_tpu_torch.cli", "--quant", "int4",
           "--prompt", "Why is the sky blue?", "--sample-len", "8"]
    t0 = time.perf_counter()
    child = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def join() -> None:
        try:
            stdout, stderr = child.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            child.kill()
            fail("generate int4: the command line ran past 600 s")
        log(f"generate int4: `{' '.join(cmd[1:])}` exit {child.returncode} "
            f"in {time.perf_counter() - t0:.1f} s; stdout tail "
            f"{stdout.strip().splitlines()[-1:]!r}")
        if child.returncode != 0 or "weights quantized to int4" not in \
                stderr:
            fail(f"generate int4: the command line failed:\n"
                 f"{stderr[-3000:]}")
    return join


# the serve phase's three drives of the same six chats through one engine
SERVE_DRIVES = ("cold", "warm", "profiled")


def phase_serve(torch, rpa, cfg, params, kv_dtype=None, i4=None,
                decode_scan: int = 1, drives=SERVE_DRIVES) -> tuple:
    """Six concurrent chats (three SSE) of 32 greedy tokens through the
    HTTP API and the paged engine, over a bf16 pool or with kv_dtype
    "int8"/"int4" a quantized one, at --decode-scan `decode_scan` (the
    option left out for a tree whose Args lack it). Three drives of the
    same chats through one engine: cold (the first, which captures the
    decode graphs), warm, and warm under torch.profiler (the device's
    busy share of the drive's wall; `drives` names the ones to run).
    Each prints decode tok/s (the
    engine's tokens over its decode time in the drive), TTFT p50 and the
    served wall. Returns (launch counts of the kernels the path runs,
    read after the three drives; the pool's GiB; the drives' records).
    With `i4` (the int4 matmul module) `params` hold int4 weights: its
    launches are counted too, 7 per layer and decode step (a mixed
    step's 8 x 64 rows take the dequantize route)."""
    import dataclasses

    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.ops.sampling import SamplingConfig

    dev = "cuda"
    scan = ({"decode_scan": decode_scan}
            if "decode_scan" in {f.name for f in dataclasses.fields(Args)}
            else {})
    if decode_scan != 1 and not scan:
        fail("this tree's Args have no decode_scan")
    args = Args(max_slots=8, max_seq_len=2048, kv_pages=128,
                kv_page_size=128, prefill_chunk=64, temperature=0.0,
                sample_len=32, dtype="bf16", kv_dtype=kv_dtype,
                **scan).validate()
    label = (f"serve ({kv_dtype or 'bf16'} pool"
             f"{', int4 weights' if i4 else ''}, decode_scan {decode_scan})")
    gen = LlamaGenerator(cfg, params, ByteTokenizer(cfg.vocab_size),
                         max_seq_len=2048,
                         sampling=SamplingConfig(temperature=0.0),
                         cache_dtype=torch.bfloat16, device=dev)
    master = Master(args, text_generator=gen)
    engine = master.make_engine()
    _note_fifo(engine, label)
    httpd = start(master, "127.0.0.1:0", block=False, engine=engine)
    url = (f"http://127.0.0.1:{httpd.server_address[1]}"
           "/api/v1/chat/completions")
    long_text = " ".join(f"word{i}" for i in range(60))   # ~400 tokens
    prompts = ["Why is the sky blue?", long_text, "Name three colours.",
               "Count to five.", "Tell me about pages.", "Hello there."]
    results = [None] * len(prompts)

    def one(i):
        stream = i % 2 == 1          # three SSE, three buffered
        body = {"messages": [{"role": "user", "content": prompts[i]}],
                "max_tokens": 32, "temperature": 0.0, "stream": stream}
        t_start = time.perf_counter()
        try:
            with _post(url, body) as r:
                if not stream:
                    doc = json.loads(r.read())
                    results[i] = dict(status=r.status, stream=False,
                                      text=doc["choices"][0]["message"]
                                      ["content"],
                                      wall=time.perf_counter() - t_start)
                    return
                first, chunks, finish, done = None, 0, None, False
                for raw in r:
                    line = raw.decode().strip()
                    if line == "data: [DONE]":
                        done = True
                    if not line.startswith("data: ") or done:
                        continue
                    if first is None:
                        first = time.perf_counter() - t_start
                    obj = json.loads(line[6:])
                    if "error" in obj:
                        raise RuntimeError(obj["error"])
                    if obj["choices"][0]["delta"].get("content"):
                        chunks += 1
                    finish = obj["choices"][0]["finish_reason"] or finish
                # random weights mostly pick ids outside the byte
                # tokenizer's range, so text chunks may be few; the
                # stream must still end with a stop chunk and [DONE]
                results[i] = dict(status=r.status if finish == "stop"
                                  and done else -2, stream=True,
                                  first_event_s=first, chunks=chunks,
                                  wall=time.perf_counter() - t_start)
        except Exception as e:   # noqa: BLE001
            results[i] = dict(status=-1, error=repr(e))

    def drive():
        t_serve = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        return time.perf_counter() - t_serve

    rpa.reset_launch_counts()
    if i4 is not None:
        i4.reset_launch_counts()
    stats = engine.stats
    records = []
    for run in drives:
        results[:] = [None] * len(prompts)
        tok0, dec0, steps0 = (stats.tokens_generated, stats.decode_time_s,
                              stats.steps)
        n0 = len(engine.retired)
        prof_rows = []
        wall = _profiled(torch, run == "profiled", f"{label} [{run}]", drive,
                         prof_rows)
        # an SSE client reads its last chunk before the engine releases
        # the request's pages and retires it, so wait for the engine to
        # retire every request before reading its records
        deadline = time.monotonic() + 30.0
        while (len(engine.retired) < n0 + len(prompts)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        for i, r in enumerate(results):
            if r is None or r.get("status") != 200:
                fail(f"{label} [{run}] request {i} failed: {r}")
        retired = list(engine.retired)[n0:]
        n_tok = [len(r.out_tokens) for r in retired]
        if len(retired) != len(prompts) or any(n != 32 for n in n_tok):
            fail(f"{label} [{run}]: expected {len(prompts)} requests of 32 "
                 f"tokens, got {n_tok}")
        dec = stats.decode_time_s - dec0
        rec = dict(
            label=label, run=run, wall_s=wall,
            decode_tok_s=(stats.tokens_generated - tok0) / dec if dec else 0,
            ttft_p50_s=statistics.median(r.first_token_t - r.submit_t
                                         for r in retired),
            steps=stats.steps - steps0,
            busy=(sum(t for t, _, _ in prof_rows) / 1e6 / wall
                  if prof_rows else None))
        records.append(rec)
        log(f"{label} [{run}]: decode {rec['decode_tok_s']:.1f} tok/s, TTFT "
            f"p50 {rec['ttft_p50_s']:.3f} s, wall {wall:.2f} s, "
            f"{rec['steps']} engine steps"
            + (f", device busy {100 * rec['busy']:.1f}%"
               if rec["busy"] is not None else ""))
    counts = dict(rpa.LAUNCHES)
    if i4 is not None:
        counts.update(i4.LAUNCHES)
    mine = [(t, n) for t, n, name in prof_rows if "::int4_" in name]
    httpd.shutdown()
    httpd.server_close()
    engine.stop()
    gib = engine.cache.memory_bytes() / 2**30
    log(f"{label}: launches {counts}; pool {gib:.3f} GiB (the sink page "
        f"included); pool pages free {engine._pager.free_pages}/"
        f"{engine.cache.n_pages}")
    suffix = _kernel_suffix(kv_dtype)
    if hasattr(rpa, "mixed_split_plan"):
        # the served shapes' mixed body, asked of the wrapper's gate on
        # small tensors of the served dtypes
        H, KV, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        store = {"int8": torch.int8, "int4": torch.uint8}.get(
            kv_dtype, torch.bfloat16)
        pool = torch.zeros((1, 64 if kv_dtype == "int4" else 128, KV, hd),
                           dtype=store, device=dev)
        kw = ({} if kv_dtype is None
              else dict(scale_k=torch.ones((1, KV), device=dev)))
        q = torch.zeros((8, 64, H, hd), dtype=torch.bfloat16, device=dev)
        log(f"{label}: rpa_mixed{suffix} at B = 8, C = 64, 16 table "
            f"columns: {_mixed_body(rpa, q, pool, pool, kw, 16, 128)}")
    if engine._pager.free_pages != engine.cache.n_pages:
        fail(f"{label}: pages leaked after every request retired")
    served = [b + suffix for b in ("rpa_decode", "rpa_mixed")]
    for k in served:
        if counts[k] <= 0:
            fail(f"{label}: kernel {k} was never launched on the served "
                 "path")
    ran_plain = {k: n for k, n in counts.items() if k.endswith("_plain") and n}
    if ran_plain:
        fail(f"{label}: plain folds ran on the served path: {ran_plain}")
    if i4 is not None:
        served.append("int4_matmul")
        if mine:
            log(f"{label}: int4_matmul kernels {sum(n for _, n in mine)} "
                f"launches, {sum(t for t, _ in mine) / 1e3:.2f} ms of "
                f"device time (profiled drive)")
        L = cfg.num_hidden_layers
        want = 7 * counts["rpa_decode" + suffix]     # 32 per decode step
        if counts["int4_matmul"] != want or want <= 0:
            fail(f"{label}: {counts['int4_matmul']} int4_matmul launches, "
                 f"expected {want} (7 x {L} per decode step)")
    del engine, master, gen, httpd
    torch.cuda.empty_cache()
    return {k: counts[k] for k in served}, gib, records


# -- phase: prefix ------------------------------------------------------------

# kernel against plain at full depth, bf16: layer 0's pages are written
# before any attention, so they must be byte-identical; past it the two
# routes drift apart through 32 layers of bf16 rounding (flash rounds p
# to bf16, as Pallas does; the einsum keeps it in f32), so logits and
# pages are held to a share of their largest magnitude
PREFIX_REL_TOL = 5e-2
# the system message of the prefix phase's chats: its rendered Llama-3
# head is 701 byte tokens, 5 shared pages of 128 after rounding down
PREFIX_SYSTEM = ("You are a careful assistant for a team that shares one "
                 "long system prompt. " * 8)[:630]
# the prefix phase's device (a rehearsal on the CPU may set another)
DEV = "cuda"
PREFIX_USERS = ("Why is the sky blue?", "Name three colours.",
                "Count to five.", "Tell me about pages.", "Hello there.",
                "What is a prefix?")


def _pool_leaves(cache):
    return [t for pool in (cache.k, cache.v)
            for t in (pool if isinstance(pool, tuple) else (pool,))]


def _prefix_steps(torch, fa, cfg, params, kv_dtype) -> dict:
    """The three prefills of the shared-prefix path at full width and
    depth, each run with attn="kernel" and attn="plain" on clones of one
    pool: the 640-token prefix into its 5 pages (prefill_prefix_pages,
    flash_attn), a 100-token suffix after it in a 128 bucket
    (prefill_slot_paged_prefixed at pos 640, flash_attn_cached) and a
    64-token window at pos 704 of a row that maps the prefix
    (prefill_slot_paged_chunk, flash_attn_cached over the gathered row).
    The kernel side carries on to the next call."""
    from cake_tpu_torch.kv.quantized_pool import QUANTIZED_CACHES
    from cake_tpu_torch.models.llama import paged as pg
    from cake_tpu_torch.models.llama.model import RopeTables

    dev, T, P = DEV, 2048, 128
    L = cfg.num_hidden_layers
    gen = torch.Generator(device=dev).manual_seed(21)
    rope = RopeTables.create(cfg, T, device=dev)
    if kv_dtype is None:
        cache = pg.PagedKVCache.create(cfg, 4, 32, P, T,
                                       dtype=torch.bfloat16, device=dev)
    else:
        cache = QUANTIZED_CACHES[kv_dtype].create(cfg, 4, 32, P, T,
                                                  device=dev)
    ids = lambda n: torch.randint(0, cfg.vocab_size, (1, n), generator=gen,  # noqa: E731
                                  device=dev, dtype=torch.int32)
    prefix = ids(5 * P)
    row = torch.full((T // P,), -1, dtype=torch.int32, device=dev)
    row[:5] = torch.arange(5, dtype=torch.int32, device=dev)
    table = torch.full_like(cache.table, -1)
    table[0, :8] = torch.arange(8, dtype=torch.int32, device=dev)
    table[1, :5] = torch.arange(5, dtype=torch.int32, device=dev)
    table[1, 5:8] = torch.arange(8, 11, dtype=torch.int32, device=dev)
    suffix = torch.cat([ids(100), torch.zeros((1, 28), dtype=torch.int32,
                                              device=dev)], dim=1)
    window = ids(64)
    calls = (
        ("prefill_prefix_pages", False,
         lambda c, a: pg.prefill_prefix_pages(params, prefix, row, c, rope,
                                              cfg, attn=a)),
        ("prefill_slot_paged_prefixed", True,
         lambda c, a: pg.prefill_slot_paged_prefixed(
             params, suffix, 100, 0, c, rope, cfg, n_prefix=5 * P, attn=a)),
        ("prefill_slot_paged_chunk", True,
         lambda c, a: pg.prefill_slot_paged_chunk(
             params, window, 64, 1, 5 * P + 64, c, rope, cfg, attn=a)),
    )
    label = f"prefix steps ({kv_dtype or 'bf16'} pool)"
    counts = {}
    for name, has_logits, fn in calls:
        sides = {}
        for attn in ("kernel", "plain"):
            c = cache.clone()
            fa.reset_launch_counts()
            out = fn(c, attn)
            torch.cuda.synchronize()
            sides[attn] = ((out[0] if has_logits else None), c,
                           dict(fa.LAUNCHES))
        (lk, ck, nk), (lp, cp, npl) = sides["kernel"], sides["plain"]
        kern = "flash_attn_cached" if has_logits else "flash_attn"
        want = {kern: L}
        got = {k: v for k, v in nk.items() if v}
        if got != want or any(npl.values()):
            fail(f"{label} {name}: kernel side launched {got}, plain side "
                 f"{ {k: v for k, v in npl.items() if v} }; expected {want} "
                 "and nothing on the plain side")
        counts[kern] = counts.get(kern, 0) + L
        msg = f"{label} {name}: {L} {kern} launches"
        if has_logits:
            err = (lk - lp).abs().max().item()
            ref = lp.abs().max().item()
            msg += (f"; logits max |kernel - plain| = {err:.3e} "
                    f"({err / ref:.3e} of max |plain| {ref:.3e}, tol "
                    f"{PREFIX_REL_TOL})")
            if not torch.isfinite(lk).all() or err > PREFIX_REL_TOL * ref:
                fail(msg)
        pk, pp = _pool_leaves(ck), _pool_leaves(cp)
        if not all(torch.equal(a[0], b[0]) for a, b in zip(pk, pp)):
            fail(f"{label} {name}: layer 0's pages differ between the "
                 "kernel and the plain route")
        perr = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(pk, pp))
        pref = max(b.float().abs().max().item() for b in pp)
        msg += (f"; pool layer 0 identical, max |kernel - plain| = "
                f"{perr:.3e} ({perr / pref:.3e} of {pref:.3e}, tol "
                f"{PREFIX_REL_TOL})")
        log(msg)
        if perr > PREFIX_REL_TOL * pref:
            fail(msg)
        cache = ck
        if name == "prefill_prefix_pages":
            cache.table.copy_(table)
        del sides, cp
    del cache
    torch.cuda.empty_cache()
    return counts


def _prefill_graph_steps(torch, cfg, params, kv_dtype) -> dict:
    """The captured one-slot prefills of `--mixed-batch off`
    (serve/graphs.PrefillRunner) at full width and depth against their
    eager calls from clones of one pool (attn="kernel"): ("slot", 256) a
    200-token prompt, ("prefixed", 640, 128) a 100-token suffix after
    the 5-page prefix, ("chunk", 64) a 64-token window at the unaligned
    pos 677 of the row that maps the prefix. Byte-identical real pages
    and logits (0 difference expected: the same kernels), and a
    replay's device ms beside the eager call's host ms. Returns the
    record by kind."""
    from cake_tpu_torch.kv.quantized_pool import QUANTIZED_CACHES
    from cake_tpu_torch.models.llama import paged as pg
    from cake_tpu_torch.models.llama.model import RopeTables
    from cake_tpu_torch.serve.graphs import PrefillRunner

    dev, T, P = DEV, 2048, 128
    gen = torch.Generator(device=dev).manual_seed(31)
    rope = RopeTables.create(cfg, T, device=dev)
    if kv_dtype is None:
        cache = pg.PagedKVCache.create(cfg, 2, 24, P, T,
                                       dtype=torch.bfloat16, device=dev)
    else:
        cache = QUANTIZED_CACHES[kv_dtype].create(cfg, 2, 24, P, T,
                                                  device=dev)

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen,
                             device=dev).tolist()

    rows = {0: list(range(10)), 1: [10, 11]}
    pg.prefill_prefix_pages(
        params, torch.tensor([ids(5 * P)], dtype=torch.int32, device=dev),
        torch.tensor(rows[0][:5] + [-1] * 11, dtype=torch.int32,
                     device=dev), cache, rope, cfg, attn="kernel")
    for slot, pages in rows.items():
        pg.table_set_slot(cache.table, slot, pages)
    sink = cache.n_pages

    def host_row(slot):
        r = torch.full((T // P,), -1, dtype=torch.int32)
        r[:len(rows[slot])] = torch.tensor(rows[slot], dtype=torch.int32)
        return r

    toks = {"slot": ids(200) + [0] * 56, "prefixed": ids(100) + [0] * 28,
            "chunk": ids(64)}
    cases = {
        "slot": (("slot", 256), 200, 1, 0,
                 pg.fixed_prompt_targets(host_row(1), 256, P, sink),
                 lambda c, t: pg.prefill_slot_paged(
                     params, t, 200, 1, c, rope, cfg, attn="kernel",
                     row=rows[1])),
        "prefixed": (("prefixed", 5 * P, 128), 100, 0, 0,
                     pg.fixed_prompt_targets(host_row(0)[5:], 128, P, sink),
                     lambda c, t: pg.prefill_slot_paged_prefixed(
                         params, t, 100, 0, c, rope, cfg, n_prefix=5 * P,
                         attn="kernel", row=rows[0])),
        "chunk": (("chunk", 64), 64, 0, 677,
                  pg.chunk_write_targets(cache, 677, 64, 64, host_row(0)),
                  lambda c, t: pg.prefill_slot_paged_chunk(
                      params, t, 64, 0, 677, c, rope, cfg, attn="kernel",
                      row=rows[0])),
    }
    label = f"prefill graphs ({kv_dtype or 'bf16'} pool)"
    out = {}
    for kind, (variant, n, slot, pos0, targets, eager) in cases.items():
        t = torch.tensor([toks[kind]], dtype=torch.int32, device=dev)
        ce, cr = cache.clone(), cache.clone()
        want = eager(ce, t)[0]
        torch.cuda.synchronize()
        host, ct = [], cache.clone()
        for _ in range(3):
            t0 = time.perf_counter()
            eager(ct, t)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        del ct
        runner = PrefillRunner(params, cr, rope, cfg, attn="kernel")
        got = runner.run(variant, toks[kind], n, slot, pos0,
                         targets).clone()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(_pool_leaves(ce),
                                                     _pool_leaves(cr)))
        err = (got - want).abs().max().item()
        dev_ms = []
        for _ in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            runner.replay(variant)
            e1.record()
            e1.synchronize()
            dev_ms.append(e0.elapsed_time(e1))
        out[kind] = dict(pages_identical=same, logits_err=err,
                         replay_ms=statistics.median(dev_ms),
                         eager_host_ms=statistics.median(host),
                         captures=runner.captures)
        log(f"{label} {variant}: pages byte-identical {same}, logits max "
            f"|captured - eager| {err:.3e}; replay device "
            f"{out[kind]['replay_ms']:.3f} ms, eager host "
            f"{out[kind]['eager_host_ms']:.3f} ms")
        if not same or err != 0.0 or runner.captures != 1:
            fail(f"{label} {variant}: {out[kind]}")
        del ce, cr, runner
    del cache
    torch.cuda.empty_cache()
    return out


def _prefix_serve(torch, rpa, fa, cfg, params, kv_dtype, mixed: str,
                  auto_prefix: bool, profile: bool = False) -> dict:
    """One engine behind the HTTP API (the serve phase's Args, plus
    --auto-prefix, --mixed-batch `mixed`, --decode-scan 4): a warm-up chat
    with PREFIX_SYSTEM (it registers the head), then six concurrent chats
    with the same system message and their own user turns, 32 greedy
    tokens each, while a thread samples the pages in use (with `profile`,
    under torch.profiler: the card's busy share of the drive). Returns
    the drive's record."""
    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.ops.sampling import SamplingConfig

    args = Args(max_slots=8, max_seq_len=2048, kv_pages=128,
                kv_page_size=128, prefill_chunk=64, temperature=0.0,
                sample_len=32, dtype="bf16", kv_dtype=kv_dtype,
                decode_scan=4, mixed_batch=mixed,
                auto_prefix=auto_prefix).validate()
    label = (f"prefix serve ({kv_dtype or 'bf16'} pool, mixed-batch "
             f"{mixed}, {'auto-prefix' if auto_prefix else 'no prefix'})")
    gen = LlamaGenerator(cfg, params, ByteTokenizer(cfg.vocab_size),
                         max_seq_len=2048,
                         sampling=SamplingConfig(temperature=0.0),
                         cache_dtype=torch.bfloat16, device=DEV)
    master = Master(args, text_generator=gen)
    engine = master.make_engine()
    _note_fifo(engine, "prefix serve")
    httpd = start(master, "127.0.0.1:0", block=False, engine=engine)
    url = (f"http://127.0.0.1:{httpd.server_address[1]}"
           "/api/v1/chat/completions")
    errors = []

    def chat(user):
        body = {"messages": [{"role": "system", "content": PREFIX_SYSTEM},
                             {"role": "user", "content": user}],
                "max_tokens": 32, "temperature": 0.0}
        try:
            with _post(url, body) as r:
                json.loads(r.read())
                if r.status != 200:
                    errors.append(r.status)
        except Exception as e:   # noqa: BLE001
            errors.append(repr(e))

    def wait_retired(n):
        deadline = time.monotonic() + 60.0
        while len(engine.retired) < n and time.monotonic() < deadline:
            time.sleep(0.005)

    stats = engine.stats
    rpa.reset_launch_counts()
    fa.reset_launch_counts()
    chat("Warm up.")
    wait_retired(1)
    shared, before = [], []
    if auto_prefix:
        if (len(engine._prefixes) != 1
                or any(p is None or p < 0
                       for p in engine._auto_pids.values())):
            fail(f"{label}: the system prompt's head did not register "
                 f"(registry {list(engine._prefixes)}, heads "
                 f"{list(engine._auto_pids.values())}): the auto-prefix "
                 "registration failed and requests were served whole")
        (_, shared), = engine._prefixes.values()
        idx = torch.tensor(shared, device=DEV)
        before = [t[:, idx].clone() for t in _pool_leaves(engine.cache)]
    hits0, tok0, dec0 = (stats.prefix_hits, stats.tokens_generated,
                         stats.decode_time_s)
    n0 = len(engine.retired)
    peak = [engine._pager.live_pages]
    done = threading.Event()

    def sample():
        while not done.is_set():
            peak[0] = max(peak[0], engine._pager.live_pages)
            time.sleep(0.0005)

    def drive():
        t0 = time.perf_counter()
        threads = [threading.Thread(target=chat, args=(u,))
                   for u in PREFIX_USERS]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        return time.perf_counter() - t0

    sampler = threading.Thread(target=sample)
    sampler.start()
    prof_rows = []
    wall = _profiled(torch, profile, label, drive, prof_rows)
    wait_retired(n0 + len(PREFIX_USERS))
    done.set()
    sampler.join()
    retired = list(engine.retired)[n0:]
    n_tok = [len(r.out_tokens) for r in retired]
    if errors or len(retired) != len(PREFIX_USERS) or any(
            n != 32 for n in n_tok):
        fail(f"{label}: errors {errors}, tokens {n_tok}")
    dec = stats.decode_time_s - dec0
    rec = dict(
        label=label, kv_dtype=kv_dtype or "bf16", mixed=mixed,
        auto_prefix=auto_prefix, wall_s=wall,
        prefix_hits=stats.prefix_hits - hits0,
        shared_pages=len(shared), peak_pages=peak[0],
        decode_tok_s=(stats.tokens_generated - tok0) / dec if dec else 0,
        ttft_p50_s=statistics.median(r.first_token_t - r.submit_t
                                     for r in retired),
        launches={k: v for c in (fa.LAUNCHES, rpa.LAUNCHES)
                  for k, v in c.items() if v},
        busy=(sum(t for t, _, _ in prof_rows) / 1e6 / wall
              if prof_rows else None))
    if auto_prefix:
        after = [t[:, idx] for t in _pool_leaves(engine.cache)]
        if not all(torch.equal(a, b) for a, b in zip(before, after)):
            fail(f"{label}: a shared prefix page (or its scale) was "
                 "written while serving")
        if rec["prefix_hits"] != len(PREFIX_USERS):
            fail(f"{label}: {rec['prefix_hits']} prefix hits, expected "
                 f"{len(PREFIX_USERS)}")
    httpd.shutdown()
    httpd.server_close()
    engine.stop()
    live, registry = engine._pager.live_pages, len(shared)
    if live != registry:
        fail(f"{label}: {live} pages live after every request retired, "
             f"the registry holds {registry}")
    plain = {k: v for k, v in rec["launches"].items() if k.endswith("_plain")}
    if plain:
        fail(f"{label}: plain versions ran on the served path: {plain}")
    log(f"{label}: {rec['prefix_hits']} prefix hits over "
        f"{len(PREFIX_USERS)} chats ({len(shared)} shared pages), peak "
        f"{rec['peak_pages']} pages in use, TTFT p50 "
        f"{rec['ttft_p50_s']:.3f} s, decode {rec['decode_tok_s']:.1f} "
        f"tok/s, wall {wall:.2f} s"
        + (f", device busy {100 * rec['busy']:.1f}%"
           if rec["busy"] is not None else "")
        + f"; launches {rec['launches']}")
    del engine, master, gen, httpd
    torch.cuda.empty_cache()
    return rec


def phase_prefix(torch, rpa, fa, cfg, params, card: str,
                 profile: bool = False) -> tuple:
    """Shared-prefix pages and the phase-split prefill at Llama-3-8B width
    and depth, over a bf16 and an int8 pool: the three prefills kernel
    against plain (`_prefix_steps`), then the six chats with one system
    message through the HTTP API at --mixed-batch auto and off with
    --auto-prefix, against the same chats without it (each drive under
    torch.profiler with `profile`). Returns (the flash launches of the
    served drives, the drives' records)."""
    import cake_tpu_torch.serve.graphs as graphs

    served = {"flash_attn": 0, "flash_attn_cached": 0}
    records = []
    for kv in (None, "int8"):
        _prefix_steps(torch, fa, cfg, params, kv)
        if hasattr(graphs, "PrefillRunner"):
            _prefill_graph_steps(torch, cfg, params, kv)
        recs = {(m, a): _prefix_serve(torch, rpa, fa, cfg, params, kv, m, a,
                                      profile)
                for m, a in (("auto", False), ("auto", True), ("off", True))}
        base = recs[("auto", False)]["peak_pages"]
        for (m, a), r in recs.items():
            if a and not r["peak_pages"] < base:
                fail(f"{r['label']}: peak {r['peak_pages']} pages, not "
                     f"fewer than {base} without the prefix")
            if a:
                for k in served:
                    served[k] += r["launches"].get(k, 0)
        off = recs[("off", True)]["launches"]
        if not (off.get("flash_attn", 0) > 0
                and off.get("flash_attn_cached", 0) > 0):
            fail(f"prefix ({kv or 'bf16'} pool): the mixed-batch off drive "
                 f"launched {off}, expected flash_attn and "
                 "flash_attn_cached")
        records += list(recs.values())
    for r in records:
        busy = "-" if r["busy"] is None else f"{100 * r['busy']:.1f}%"
        log(f"prefix summary: {r['label']:<58} hits {r['prefix_hits']}  "
            f"peak pages {r['peak_pages']:3d}  TTFT p50 "
            f"{r['ttft_p50_s']:.3f} s  decode {r['decode_tok_s']:7.1f} "
            f"tok/s  wall {r['wall_s']:5.2f} s  busy {busy}  [{card}]")
    return served, records



# -- phase: sched -------------------------------------------------------------

# the sched phase's pool: 40 pages of 128 tokens (+ the sink), 8 slots
SCHED_PAGES = 40
SCHED_LAYERS_F32 = 4       # the f32 identity drive's depth (8B width)
# (round, class, prompt tokens, max tokens, how many); round A: six
# batch chats of 6 pages each (36), then two interactive of 3 (the
# second finds 4 free and must preempt one batch slot for "pages");
# round B: eight batch chats fill every slot, one interactive preempts
# for "slots"
SCHED_ROUNDS = {
    "A": (("batch", 512, 256, 6), ("interactive", 300, 64, 2)),
    "B": (("batch", 128, 64, 8), ("interactive", 128, 32, 1)),
}
MFU_RAW_MAX = 1.05
HBM_SHARE_TOL = 0.30       # decode records' HBM share against bound/replay


def _metric(text: str, name: str, **labels) -> float:
    """One sample of a Prometheus exposition (0 when absent)."""
    want = ",".join(f'{k}="{v}"' for k, v in labels.items())
    pat = "^" + re.escape(name) + (r"\{" + re.escape(want) + r"\}" if want
                                   else "") + r" (\S+)$"
    m = re.search(pat, text, re.M)
    return float(m.group(1)) if m else 0.0


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read()


def _tagged_chat(tokenizer, tag: str, n_tokens: int) -> str:
    """A user message (no system message) whose Llama-3 rendering encodes
    to exactly n_tokens byte tokens, starting with `tag`."""
    from cake_tpu_torch.models.chat import History, Message

    h = History("llama3")
    h.add_message(Message.user(""))
    room = n_tokens - len(tokenizer.encode(h.render())) - len(tag) - 1
    if room < 0:
        fail(f"a {n_tokens}-token chat cannot hold its template and tag")
    return f"{tag} " + "".join("abcdefgh"[i % 8] for i in range(room))


class _SchedServer:
    """One engine behind the HTTP API at the sched phase's geometry, and
    the client side of the rounds: chats posted from threads with their
    class in the body, each named by the tag its message starts with (the
    same tags, so the same prompts, in every drive)."""

    def __init__(self, torch, cfg, params, dtype, classes: bool,
                 shed: bool = False, sched_config=None, engine_kw=None,
                 max_seq_len: int = 2048, **args_kw):
        from cake_tpu_torch.api.server import start
        from cake_tpu_torch.args import Args
        from cake_tpu_torch.master import Master
        from cake_tpu_torch.models.llama.generator import (
            ByteTokenizer, LlamaGenerator,
        )
        from cake_tpu_torch.ops.sampling import SamplingConfig

        # args_kw: more Args fields (the tiers phase's --kv-dtype,
        # --kv-host-pages, --kv-pages, --auto-prefix; the control phase's
        # --autotune, --sentinel ...); engine_kw: InferenceEngine
        # arguments beside them (the control phase's autotune_config)
        args = Args(**{**dict(
            max_slots=8, max_seq_len=max_seq_len, kv_pages=SCHED_PAGES,
            kv_page_size=128, prefill_chunk=64, temperature=0.0,
            sample_len=32, decode_scan=4, step_ring=8192,
            priority_classes=classes, shed=shed), **args_kw}).validate()
        self.gen = LlamaGenerator(cfg, params, ByteTokenizer(cfg.vocab_size),
                                  max_seq_len=max_seq_len,
                                  sampling=SamplingConfig(temperature=0.0),
                                  cache_dtype=dtype, device=DEV)
        self.master = Master(args, text_generator=self.gen)
        kw = {"sched_config": sched_config} if sched_config else {}
        kw.update(engine_kw or {})
        self.engine = self.master.make_engine(**kw)
        if not classes:
            _note_fifo(self.engine, "a FIFO drive (_SchedServer)")
        self.httpd = start(self.master, "127.0.0.1:0", block=False,
                           engine=self.engine)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.threads, self.status, self._reqs = [], {}, {}

    def post(self, system: str, cls: str, n_prompt: int, max_tokens: int,
             head: str = None):
        """A chat tagged `system` (its user message's n_prompt tokens),
        after a system message `head` when given."""
        user = _tagged_chat(self.engine.tokenizer, system, n_prompt)
        msgs = [{"role": "user", "content": user}]
        if head is not None:
            msgs.insert(0, {"role": "system", "content": head})
        body = {"messages": msgs, "max_tokens": max_tokens,
                "temperature": 0.0, "priority": cls}

        def one():
            try:
                with _post(self.url + "/api/v1/chat/completions",
                           body) as r:
                    json.loads(r.read())
                    self.status[system] = (r.status, None)
            except urllib.error.HTTPError as e:
                self.status[system] = (e.code,
                                       e.headers.get("Retry-After"))
            except Exception as e:   # noqa: BLE001
                self.status[system] = (-1, repr(e))

        t = threading.Thread(target=one)
        t.start()
        self.threads.append(t)

    def request(self, system: str):
        """The engine's request for a chat (live or retired), by its tag
        (found once, then kept)."""
        got = self._reqs.get(system)
        if got is None:
            key = f"\n\n{system} "
            dec = self.engine.tokenizer.decode
            for req in list(self.engine._requests.values()) + list(
                    self.engine.retired):
                if key in dec(req.prompt_ids):
                    got = self._reqs[system] = req
                    break
        return got

    def wait_tokens(self, systems, n: int, timeout: float = 120.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            reqs = [self.request(s) for s in systems]
            if all(r is not None and len(r.out_tokens) >= n for r in reqs):
                return
            time.sleep(0.005)
        fail(f"sched: {systems} did not reach {n} tokens")

    def join(self):
        for t in self.threads:
            t.join(timeout=900)
        self.threads = []

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.engine.stop()


def _sched_round(srv: "_SchedServer", rnd: str, tag: str) -> dict:
    """One round's arrivals: the batch chats together, then (once every
    batch chat is decoding) the interactive ones one after the other,
    each once the one before it has its first token. Returns system ->
    (class, the request) after every chat has completed."""
    (bcls, bp, bn, bk), (icls, ip, inn, ik) = SCHED_ROUNDS[rnd]
    batch = [f"{rnd}b{i}" for i in range(bk)]
    inter = [f"{rnd}i{i}" for i in range(ik)]
    for sysmsg in batch:
        srv.post(sysmsg, bcls, bp, bn)
    srv.wait_tokens(batch, 8)
    for sysmsg in inter:
        srv.post(sysmsg, icls, ip, inn)
        srv.wait_tokens([sysmsg], 1)
    srv.join()
    out = {}
    for sysmsg, cls in [(b, bcls) for b in batch] + [(i, icls)
                                                    for i in inter]:
        code, err = srv.status.get(sysmsg, (None, None))
        if code != 200:
            fail(f"sched round {rnd} ({tag}): {sysmsg!r} got {code} {err}")
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            req = srv.request(sysmsg)
            if req is not None and req.done.is_set():
                break
            time.sleep(0.005)
        out[sysmsg] = (cls, req)
    return out


def _sched_drive(torch, cfg, params, dtype, classes: bool, tag: str):
    """Rounds A and B through one server: returns (the rounds' requests,
    the preemptions by round and reason read from /metrics, the server,
    still open)."""
    srv = _SchedServer(torch, cfg, params, dtype, classes)
    rounds, preempted = {}, {}
    for rnd in SCHED_ROUNDS:
        before = _get(srv.url + "/metrics").decode()
        rounds[rnd] = _sched_round(srv, rnd, tag)
        after = _get(srv.url + "/metrics").decode()
        preempted[rnd] = {
            r: _metric(after, "cake_preemptions_total", reason=r)
            - _metric(before, "cake_preemptions_total", reason=r)
            for r in ("pages", "slots")}
        free = srv.engine._pager.free_pages
        if free != SCHED_PAGES:
            fail(f"sched round {rnd} ({tag}): {free} of {SCHED_PAGES} "
                 "pages free after every chat completed")
    return rounds, preempted, srv


def _sched_identity(rounds, fifo, label: str, card: str,
                    required: bool) -> list:
    """Each preempted stream against the same chat in the FIFO drive:
    prints where each differs (if it does); with `required` a difference
    fails. Returns the preempted chats' (system, tokens, preemptions)."""
    victims = []
    for rnd, chats in rounds.items():
        for sysmsg, (cls, req) in chats.items():
            want = fifo[rnd][sysmsg][1].out_tokens
            if req.out_tokens != want:
                k = next((i for i, (a, b) in enumerate(
                    zip(req.out_tokens, want)) if a != b),
                    min(len(req.out_tokens), len(want)))
                msg = (f"sched identity ({label}): {sysmsg!r} "
                       f"({'preempted' if req.preemptions else 'never preempted'}) "
                       f"differs from the FIFO drive at token {k} of "
                       f"{len(want)}")
                if required:
                    fail(msg)
                log(msg + f" [{card}]")
            if req.preemptions:
                victims.append((sysmsg, len(req.out_tokens),
                                req.preemptions,
                                req.out_tokens == want))
    for v in victims:
        log(f"sched identity ({label}): victim {v[0]!r}: {v[1]} tokens, "
            f"preempted {v[2]}x, identical to FIFO: {v[3]} [{card}]")
    return victims


def _sched_shed(torch, cfg, params, card: str) -> dict:
    """A burst of batch chats past the shed's depth: a server with
    --priority-classes --shed whose batch class holds a 1 s queue-wait
    target; four warm-up chats one after the other, then a second's
    pause, give the controller a measured rate of a few retirements a
    second, then 48 batch chats arrive at once. Some must get 429 with a
    Retry-After above 0 (and every other one 200)."""
    from cake_tpu_torch.sched import SchedConfig
    from cake_tpu_torch.sched.classes import DEFAULT_POLICIES, ClassPolicy

    pol = tuple(ClassPolicy(p.name, p.rank, p.aging_s,
                            1.0 if p.name == "batch" else p.target_wait_s)
                for p in DEFAULT_POLICIES)
    srv = _SchedServer(torch, cfg, params, torch.bfloat16, True, shed=True,
                       sched_config=SchedConfig(policies=pol))
    for i in range(4):
        srv.post(f"W{i}", "batch", 160, 4)
        srv.join()
    time.sleep(1.0)
    burst = [f"S{i}" for i in range(48)]
    for sysmsg in burst:
        srv.post(sysmsg, "batch", 160, 8)
    srv.join()
    codes = [srv.status[s] for s in burst]
    shed = [ra for c, ra in codes if c == 429]
    if not shed or any(c not in (200, 429) for c, _ in codes):
        fail(f"sched shed: expected some 429s and otherwise 200, got "
             f"{sorted(set(c for c, _ in codes))}")
    if any(ra is None or float(ra) <= 0 for ra in shed):
        fail(f"sched shed: 429 without a Retry-After above 0: {shed}")
    evs = json.loads(_get(srv.url + "/api/v1/events?type=shed"))
    text = _get(srv.url + "/metrics").decode()
    n_metric = _metric(text, "cake_shed_requests_total", **{"class": "batch"})
    rec = dict(admitted=len(codes) - len(shed), shed=len(shed),
               retry_after_s=sorted(set(int(r) for r in shed)),
               events=len(evs["events"]), metric=n_metric)
    if rec["events"] != len(shed):
        fail(f"sched shed: {len(shed)} 429s but {rec['events']} shed events")
    log(f"sched shed: 48 batch chats at once: {rec['admitted']} admitted, "
        f"{rec['shed']} shed with Retry-After {rec['retry_after_s']} s "
        f"(cake_shed_requests_total{{class=batch}} {n_metric:.0f}) [{card}]")
    srv.close()
    return rec


def _sched_steps(srv, card: str) -> dict:
    """The classes drive's flight records through /api/v1/steps: every
    record's mfu in (0, 1] and its unclamped ratios (the engine's own
    records) at most MFU_RAW_MAX; mean mfu and hbm_util per kind; the
    decode records' HBM share against the step phase's bound over its
    replay (when the step phase ran in this call)."""
    doc = json.loads(_get(srv.url + "/api/v1/steps?limit=8192"))
    steps = doc["steps"]
    raw = srv.engine.flight.records()
    if not steps or len(raw) != len(steps):
        fail(f"sched steps: {len(steps)} records served, {len(raw)} held")
    bad = [s for s in steps if s["mfu"] is None or not 0 < s["mfu"] <= 1
           or s["hbm_util"] is None or not 0 < s["hbm_util"] <= 1]
    if bad:
        fail(f"sched steps: {len(bad)} records with mfu or hbm_util "
             f"outside (0, 1], e.g. {bad[0]}")
    top = max(max(r.mfu_raw, r.hbm_raw) for r in raw)
    if top > MFU_RAW_MAX:
        fail(f"sched steps: an unclamped ratio of {top:.3f} (> "
             f"{MFU_RAW_MAX}): the count or the clock is wrong")
    kinds = {}
    for s in steps:
        if s["compiled"]:
            continue
        k = kinds.setdefault(s["kind"], {"n": 0, "mfu": 0.0, "hbm": 0.0,
                                         "dev_ms": 0.0, "tokens": 0})
        k["n"] += 1
        k["mfu"] += s["mfu"]
        k["hbm"] += s["hbm_util"]
        k["dev_ms"] += s["device_s"] * 1e3
        k["tokens"] += s["tokens"]
    for name, k in sorted(kinds.items()):
        k["mfu"] /= k["n"]
        k["hbm"] /= k["n"]
        k["dev_ms"] /= k["n"]
        log(f"sched steps: {name:<12} {k['n']:4d} records, mean mfu "
            f"{k['mfu']:.5f}, mean hbm_util {k['hbm']:.4f}, mean device "
            f"{k['dev_ms']:.3f} ms [{card}]")
    log(f"sched steps: largest unclamped ratio {top:.4f}; summary "
        f"{json.dumps(doc['summary']['kinds'])}")
    out = {"kinds": kinds, "raw_max": top}
    rep = GRAPH_REPLAY.get("bf16 weights")
    dec = [s for s in steps if s["kind"] in ("decode", "decode_scan")
           and not s["compiled"]]
    if dec:
        share = statistics.mean(s["hbm_util"] for s in dec)
        out["decode_hbm_util"] = share
        if rep is None:
            log(f"sched steps: decode hbm_util {share:.4f}; the step phase "
                "did not run, so no bound/replay to hold it against")
        else:
            replay_ms, bound_ms = rep
            want = bound_ms / replay_ms
            out["bound_over_replay"] = want
            log(f"sched steps: decode hbm_util {share:.4f} against the "
                f"step phase's bound {bound_ms:.3f} ms over its replay "
                f"{replay_ms:.3f} ms = {want:.4f} [{card}]")
            if abs(share / want - 1) > HBM_SHARE_TOL:
                fail(f"sched steps: decode hbm_util {share:.4f} is not "
                     f"within {HBM_SHARE_TOL:.0%} of bound/replay "
                     f"{want:.4f}")
    return out


def phase_sched(torch, rpa, cfg, params, card: str) -> tuple:
    """SLO scheduling and the observability core through the front door
    at Llama-3-8B width and depth, random bf16 weights: a 40-page bf16
    pool, 8 slots, chunk 64, --decode-scan 4. Rounds A (page
    preemption) and B (slot preemption) with --priority-classes, then
    the same arrivals without (the FIFO drive): exactly one "pages" and
    one "slots" preemption by /metrics, every chat completes, the free
    pages back to 40; interactive TTFT p50 with and without classes;
    /api/v1/steps records with mfu in (0, 1] (unclamped at most
    MFU_RAW_MAX), means per kind, and the decode records' HBM share
    against the step phase's bound over its replay. Each preempted
    stream is compared token for token with the FIFO drive's: at bf16
    printed, at f32 (the same rounds at 8B width, SCHED_LAYERS_F32
    layers, f32 weights and pool) required. Then the shed burst.
    Returns (the decode and mixed kernels' launches on the classes
    drive, the phase's record)."""
    from cake_tpu_torch.models.llama.params import init_params

    t_phase = time.perf_counter()
    rpa.reset_launch_counts()
    rounds, preempted, srv = _sched_drive(torch, cfg, params,
                                          torch.bfloat16, True, "bf16")
    counts = dict(rpa.LAUNCHES)
    steps = _sched_steps(srv, card)
    srv.close()
    want = {"A": {"pages": 1.0, "slots": 0.0},
            "B": {"pages": 0.0, "slots": 1.0}}
    if preempted != want:
        fail(f"sched: preemptions by round and reason {preempted}, "
             f"expected {want}")
    for k in ("rpa_decode", "rpa_mixed"):
        if counts.get(k, 0) <= 0:
            fail(f"sched: kernel {k} was never launched on the drive")
    plain = {k: n for k, n in counts.items() if k.endswith("_plain") and n}
    if plain:
        fail(f"sched: plain versions ran on the drive: {plain}")
    fifo, fifo_pre, fsrv = _sched_drive(torch, cfg, params, torch.bfloat16,
                                        False, "bf16")
    fsrv.close()
    if any(v for r in fifo_pre.values() for v in r.values()):
        fail(f"sched: the FIFO drive preempted: {fifo_pre}")
    victims = _sched_identity(rounds, fifo, "bf16, 32 layers", card,
                              required=False)

    def ttft(rs, cls):
        return statistics.median(
            req.first_token_t - req.submit_t for r in rs.values()
            for c, req in r.values() if c == cls)

    rec = dict(preempted=preempted, launches=counts,
               ttft_interactive_classes_s=ttft(rounds, "interactive"),
               ttft_interactive_fifo_s=ttft(fifo, "interactive"),
               ttft_batch_classes_s=ttft(rounds, "batch"),
               ttft_batch_fifo_s=ttft(fifo, "batch"),
               victims_bf16=victims, steps=steps)
    log(f"sched: preemptions {preempted}; interactive TTFT p50 "
        f"{rec['ttft_interactive_classes_s']:.3f} s with classes, "
        f"{rec['ttft_interactive_fifo_s']:.3f} s FIFO; batch "
        f"{rec['ttft_batch_classes_s']:.3f} / "
        f"{rec['ttft_batch_fifo_s']:.3f} s; launches {counts} [{card}]")
    # the fold's token identity at f32 (bf16 rounding makes the
    # re-prefilled KV of the generated tokens differ from what the
    # decode steps wrote, and 32 random layers turn that into greedy
    # near-tie flips)
    import dataclasses
    cfg32 = dataclasses.replace(cfg, num_hidden_layers=SCHED_LAYERS_F32)
    p32 = init_params(cfg32, torch.Generator(device=DEV).manual_seed(3),
                      device=DEV, dtype=torch.float32)
    r32, pre32, s32 = _sched_drive(torch, cfg32, p32, torch.float32, True,
                                   "f32")
    s32.close()
    if pre32 != want:
        fail(f"sched (f32): preemptions {pre32}, expected {want}")
    f32, _, f32s = _sched_drive(torch, cfg32, p32, torch.float32, False,
                                "f32")
    f32s.close()
    rec["victims_f32"] = _sched_identity(
        r32, f32, f"f32, {SCHED_LAYERS_F32} layers", card, required=True)
    if not rec["victims_f32"]:
        fail("sched (f32): no preempted stream to compare")
    del p32
    torch.cuda.empty_cache()
    rec["shed"] = _sched_shed(torch, cfg, params, card)
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"sched: phase wall {rec['wall_s']:.1f} s [{card}]")
    return {k: counts[k] for k in ("rpa_decode", "rpa_mixed")}, rec


# -- phase: tiers -------------------------------------------------------------

# drive 1: six chats of these user tokens, 32 greedy tokens each
TIER_CHATS = (160, 400, 180, 200, 300, 140)
TIER_HOST_PAGES = 64
# drive 4: the pool holds the 5-page prefix and three 3-page chats; eight
# chats of 200 + 120 tokens arrive at once
TIER_OVER_PAGES = 14
TIER_OVER_CHATS = 8


def _tier_chats(srv, tag: str, n_new: int = 32) -> list:
    """The six TIER_CHATS through one server at once; their requests,
    once every one completed with 200."""
    names = [f"{tag}{i}" for i in range(len(TIER_CHATS))]
    for name, n in zip(names, TIER_CHATS):
        srv.post(name, "standard", n, n_new)
    srv.join()
    reqs = []
    for name in names:
        code, err = srv.status.get(name, (None, None))
        if code != 200:
            fail(f"tiers {tag}: {name!r} got {code} {err}")
        reqs.append(srv.request(name))
    return reqs


def _tier_fp8(torch, rpa, cfg, params, card: str) -> tuple:
    """Drive 1: the six chats over a bf16, an fp8 e4m3 and an fp8 e5m2
    pool (40 pages, --decode-scan 4): cold, then warm (measured: TTFT p50
    and decode tok/s); the fp8 kernels' launches on the fp8 drives, and
    no plain version; the pools' GiB. Then the tier's spill and restore
    of 8 pages of the bf16 and the e4m3 pool, timed with CUDA events."""
    from cake_tpu_torch.kv.host_tier import HostTier

    recs, counts, moves = {}, {}, {}
    for kv in (None, "f8_e4m3", "f8_e5m2"):
        srv = _SchedServer(torch, cfg, params, torch.bfloat16, False,
                           kv_dtype=kv, kv_host_pages=TIER_HOST_PAGES)
        eng = srv.engine
        if kv is not None:
            rpa.reset_launch_counts()
        _tier_chats(srv, f"T{kv or 'bf'}c")
        rec = {"pool_gib": eng.cache.memory_bytes() / 2**30}
        if kv != "f8_e5m2":
            st = eng.stats
            tok0, dec0 = st.tokens_generated, st.decode_time_s
            reqs = _tier_chats(srv, f"T{kv or 'bf'}w")
            rec.update(
                ttft_p50_s=statistics.median(r.first_token_t - r.submit_t
                                             for r in reqs),
                decode_tok_s=(st.tokens_generated - tok0)
                / (st.decode_time_s - dec0))
        if kv is not None:
            got = dict(rpa.LAUNCHES)
            suffix = _kernel_suffix(kv)
            for base in ("rpa_decode", "rpa_mixed"):
                counts[base + suffix] = got[base + suffix]
                if got[base + suffix] <= 0:
                    fail(f"tiers ({kv}): {base + suffix} never launched")
            plain = {k: n for k, n in got.items()
                     if k.endswith("_plain") and n}
            if plain:
                fail(f"tiers ({kv}): plain versions ran: {plain}")
        srv.close()
        if kv != "f8_e5m2":
            # the tier's copies of 8 pages of this pool (the engine stopped)
            pages = list(range(8))
            cache = eng.cache
            per_page = eng._host_tier.page_bytes
            for _ in range(2):                      # pinned memory warm
                HostTier.install_pages(cache, pages,
                                       HostTier.fetch_pages(cache, pages))
            torch.cuda.synchronize()
            t_sp, t_rs = [], []
            for _ in range(10):
                a, b, c = (torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
                a.record()
                arrays = HostTier.fetch_pages(cache, pages)
                b.record()
                HostTier.install_pages(cache, pages, arrays)
                c.record()
                c.synchronize()
                t_sp.append(a.elapsed_time(b) / len(pages))
                t_rs.append(b.elapsed_time(c) / len(pages))
            moves[kv or "bf16"] = dict(
                page_mib=per_page / 2**20,
                spill_ms_page=statistics.median(t_sp),
                restore_ms_page=statistics.median(t_rs))
            m = moves[kv or "bf16"]
            log(f"tiers: {kv or 'bf16'} pool page ({m['page_mib']:.1f} "
                f"MiB, {cfg.num_hidden_layers} layers): spill "
                f"{m['spill_ms_page']:.3f} ms, "
                f"restore {m['restore_ms_page']:.3f} ms a page (device, "
                f"CUDA events, 8 pages a move, median of 10) = "
                f"{per_page / m['spill_ms_page'] / 1e6:.1f} / "
                f"{per_page / m['restore_ms_page'] / 1e6:.1f} GB/s [{card}]")
        recs[kv or "bf16"] = rec
        log(f"tiers fp8 ({kv or 'bf16'} pool): " + ", ".join(
            f"{k} {v:.4f}" for k, v in rec.items()) + f" [{card}]")
        del srv, eng
        torch.cuda.empty_cache()
    return counts, dict(drives=recs, moves=moves)


def _spy_victims(engine) -> dict:
    """rid -> the victim's own pages' bytes before its spill ("before")
    and after their install ("after"), copied on the device (the spies
    wait for nothing)."""
    from cake_tpu_torch.kv.host_tier import HostTier

    snaps = {}
    spill, restore = engine._spill_victim_pages, engine._restore_victim

    def leaves(pages):
        return [x[:, pages].clone() for x in HostTier._stores(engine.cache)]

    def spill_spy(req, slot):
        own = (engine._slot_pages.get(slot) or [])[
            engine._slot_prefix_pages.get(slot, 0):]
        before = leaves(own) if own else None
        ok = spill(req, slot)
        if ok:
            snaps[req.rid] = {"before": before}
        return ok

    def restore_spy(req, slot, pages, ent):
        restore(req, slot, pages, ent)
        snaps.setdefault(req.rid, {})["after"] = leaves(pages)

    engine._spill_victim_pages = spill_spy
    engine._restore_victim = restore_spy
    return snaps


def _tier_round_a(torch, cfg, params, dtype, label: str, card: str):
    """The sched phase's page-starved round A with --kv-host-pages (the
    resident spill off, so the page-starved interactive chat preempts a
    batch slot): exactly one "pages" preemption, one spill and one restore of
    the victim's own pages by cake_kv_spill_total{dir}, the restored
    pages byte-identical to the spilled ones; then the same arrivals
    without classes (the FIFO drive). Returns (rounds, fifo rounds, the
    record)."""
    from cake_tpu_torch.sched import SchedConfig

    srv = _SchedServer(torch, cfg, params, dtype, True,
                       sched_config=SchedConfig(spill_resident=False),
                       kv_host_pages=TIER_HOST_PAGES)
    snaps = _spy_victims(srv.engine)
    before = _get(srv.url + "/metrics").decode()
    rounds = {"A": _sched_round(srv, "A", label)}
    after = _get(srv.url + "/metrics").decode()
    eng = srv.engine
    moved = {d: _metric(after, "cake_kv_spill_total", dir=d)
             - _metric(before, "cake_kv_spill_total", dir=d)
             for d in ("spill", "restore")}
    pre = (_metric(after, "cake_preemptions_total", reason="pages")
           - _metric(before, "cake_preemptions_total", reason="pages"))
    rec = dict(preempted_pages=pre, spills=eng.stats.kv_spills,
               restores=eng.stats.kv_restores, pages_moved=moved)
    if (pre, eng.stats.kv_spills, eng.stats.kv_restores) != (1.0, 1, 1) \
            or moved["spill"] != moved["restore"] or moved["spill"] <= 0:
        fail(f"tiers round A ({label}): {rec}; expected one pages "
             "preemption, one spill and one restore of the same pages")
    if len(snaps) != 1 or any(set(v) != {"before", "after"}
                              for v in snaps.values()):
        fail(f"tiers round A ({label}): victim snapshots {list(snaps)}")
    (snap,) = snaps.values()
    same = all(torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8))
               for a, b in zip(snap["before"], snap["after"]))
    if not same:
        fail(f"tiers round A ({label}): the restored pages differ from the "
             "spilled ones")
    if eng._pager.free_pages != SCHED_PAGES or eng._host_tier.used_pages:
        fail(f"tiers round A ({label}): pages not all back")
    srv.close()
    fsrv = _SchedServer(torch, cfg, params, dtype, False)
    fifo = {"A": _sched_round(fsrv, "A", label + " FIFO")}
    fsrv.close()
    log(f"tiers round A ({label}): one pages preemption, "
        f"{moved['spill']:.0f} pages spilled and restored, byte-identical "
        f"[{card}]")
    return rounds, fifo, rec


def _tier_oversubscribed(torch, cfg, params, card: str) -> dict:
    """Drive 4: a 14-page pool with --auto-prefix and the host tier. A
    chat with the ~630-token system message registers its 5-page head;
    then TIER_OVER_CHATS chats of 200 + 120 tokens (3 pages each) arrive
    at once, more than the pool holds: the cold prefix spills, and
    decode-resident streams park and come back in resident_quantum
    turns; every chat completes. Then a chat with the same system
    message restores the prefix and hits it. Every page comes back."""
    srv = _SchedServer(torch, cfg, params, torch.bfloat16, False,
                       kv_pages=TIER_OVER_PAGES,
                       kv_host_pages=TIER_HOST_PAGES, auto_prefix=True)
    eng = srv.engine
    srv.post("Ohead", "standard", 160, 8, head=PREFIX_SYSTEM)
    srv.join()
    t0 = time.perf_counter()
    before = _get(srv.url + "/metrics").decode()
    names = [f"Oc{i}" for i in range(TIER_OVER_CHATS)]
    for name in names:
        srv.post(name, "standard", 200, 120)
    srv.join()
    wall = time.perf_counter() - t0
    hits = eng.stats.prefix_hits
    srv.post("Otail", "standard", 160, 8, head=PREFIX_SYSTEM)
    srv.join()
    after = _get(srv.url + "/metrics").decode()
    bad = {n: srv.status.get(n) for n in names + ["Ohead", "Otail"]
           if srv.status.get(n, (None,))[0] != 200}
    if bad:
        fail(f"tiers oversubscribed: chats failed {bad}")
    evs = json.loads(_get(srv.url + "/api/v1/events?limit=10000"))["events"]
    kinds = Counter((e["type"], e.get("kind")) for e in evs
                    if e["type"] in ("kv_spill", "kv_restore"))
    rec = dict(
        resident_spills=_metric(after, "cake_kv_resident_spills_total")
        - _metric(before, "cake_kv_resident_spills_total"),
        prefix_spills=kinds[("kv_spill", "prefix")],
        prefix_restores=kinds[("kv_restore", "prefix")],
        victim_spills=kinds[("kv_spill", "victim")],
        victim_restores=kinds[("kv_restore", "victim")],
        tail_prefix_hit=eng.stats.prefix_hits - hits, wall_s=wall,
        spill_seconds_mean=(
            _metric(after, "cake_kv_spill_seconds_sum")
            / max(1.0, _metric(after, "cake_kv_spill_seconds_count"))))
    with eng._rid_lock:
        registry = {pid: e[1] for pid, e in eng._prefixes.items()}
    held = sum(len(p) for p in registry.values() if p)
    log(f"tiers oversubscribed: {TIER_OVER_CHATS} chats of 3 pages on a "
        f"{TIER_OVER_PAGES}-page pool: {rec} [{card}]")
    if (rec["resident_spills"] <= 0 or rec["prefix_spills"] < 1
            or rec["prefix_restores"] < 1 or rec["tail_prefix_hit"] != 1):
        fail(f"tiers oversubscribed: {rec}; expected resident spills, the "
             "cold prefix spilled and restored, and the last chat's hit")
    if (eng._pager.free_pages != TIER_OVER_PAGES - held
            or eng._host_tier.used_pages):
        fail(f"tiers oversubscribed: {eng._pager.free_pages} pages free, "
             f"{held} held by the registry, {eng._host_tier.used_pages} "
             "host pages used")
    for pid in registry:
        eng.unregister_prefix(pid)
    if eng._pager.free_pages != TIER_OVER_PAGES:
        fail("tiers oversubscribed: pages leaked")
    srv.close()
    return rec


def phase_tiers(torch, rpa, cfg, params, card: str) -> tuple:
    """The KV tiers at Llama-3-8B width and depth, random bf16 weights
    (drive 3: 4 layers, f32): 1. the six chats over an fp8 e4m3 pool
    against a bf16 one (TTFT p50, decode tok/s, pool GiB), an fp8 e5m2
    pool, and the tier's spill and restore ms a page; 2. round A with
    the host tier: one spill and one restore, byte-identical pages, the
    victim against the FIFO drive printed at bf16; 3. the same at 4
    layers and f32, where the victim must be token-identical; 4. an
    oversubscribed pool with a cold prefix. Returns (the fp8 kernels'
    launches on drive 1, the phase's record)."""
    import dataclasses

    from cake_tpu_torch.models.llama.params import init_params

    t_phase = time.perf_counter()
    counts, fp8 = _tier_fp8(torch, rpa, cfg, params, card)
    rec = dict(fp8=fp8)
    rounds, fifo, rec["round_a_bf16"] = _tier_round_a(
        torch, cfg, params, torch.bfloat16, "bf16", card)
    rec["round_a_bf16"]["victims"] = _sched_identity(
        rounds, fifo, f"tiers bf16, {cfg.num_hidden_layers} layers", card,
        required=False)
    cfg32 = dataclasses.replace(cfg, num_hidden_layers=SCHED_LAYERS_F32)
    p32 = init_params(cfg32, torch.Generator(device=DEV).manual_seed(3),
                      device=DEV, dtype=torch.float32)
    r32, f32, rec["round_a_f32"] = _tier_round_a(
        torch, cfg32, p32, torch.float32, "f32", card)
    rec["round_a_f32"]["victims"] = _sched_identity(
        r32, f32, f"tiers f32, {SCHED_LAYERS_F32} layers", card,
        required=True)
    if not rec["round_a_f32"]["victims"]:
        fail("tiers (f32): no preempted stream to compare")
    del p32
    torch.cuda.empty_cache()
    rec["oversubscribed"] = _tier_oversubscribed(torch, cfg, params, card)
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"tiers: phase wall {rec['wall_s']:.1f} s [{card}]")
    return counts, rec


# -- phase: recovery ----------------------------------------------------------

# drive 1's faults: a mixed step's dispatch, a decode burst's entry and
# the top of an iteration (the JAX engine's sites), each once; drive 1
# adds a fetch that raises inside a burst chain, with the next burst in
# flight
RECOVERY_PLAN = ("seed=15;engine.mixed:nth=3:transient;"
                 "engine.decode:nth=1:oom;engine.step:step=10:transient")
# every site armed, no rule fires
RECOVERY_SILENT = ("seed=15;engine.mixed:nth=1000000:transient;"
                   "engine.decode:nth=1000000:oom;"
                   "engine.step:step=1000000000:transient;"
                   "pager.alloc:nth=1000000:oom;"
                   "engine.prefill:match_len=99999:always:transient")
# the forced-fallback wave's faults (drive 1, after the faulted wave)
RECOVERY_FALLBACK = ("seed=16;engine.mixed:nth=3:transient;"
                     "engine.decode:nth=2:oom")
RECOVERY_NEW = 64            # tokens a chat (drive 1)
RECOVERY_LAYERS_F32 = 2      # the f32 drives' depth (8B width)
RECOVERY_PAGES = 128         # the serve phase's pool
RECOVERY_ABORT = ("seed=1;engine.decode:nth=10:abort")
RECOVERY_KEYS = ("jA", "jB", "jC")
# the journal drive's child builds this LlamaConfig (its classmethod)
RECOVERY_CHILD_CONFIG = "llama3_8b"


def _shift_steps(plan: str, base: int) -> str:
    """`plan` with each step=N trigger moved to base + N (a plan armed
    after `base` engine steps fires where a fresh engine's would)."""
    return re.sub(r"step=(\d+)", lambda m: f"step={base + int(m.group(1))}",
                  plan)


def _metric_sum(text: str, name: str) -> float:
    """The sum of a metric family's samples over all its labels."""
    return sum(float(m.group(1)) for m in re.finditer(
        "^" + re.escape(name) + r"(?:\{[^}]*\})? (\S+)$", text, re.M))


def _recovery_wave(srv, tag: str, n_new: int = RECOVERY_NEW) -> dict:
    """The six TIER_CHATS at once through `srv`: TTFT p50, the decode
    tok/s of the wave (the engine's tokens over its decode time) and the
    wave's wall."""
    st = srv.engine.stats
    tok0, dec0 = st.tokens_generated, st.decode_time_s
    t0 = time.perf_counter()
    reqs = _tier_chats(srv, tag, n_new)
    wall = time.perf_counter() - t0
    return dict(ttft_p50_s=statistics.median(r.first_token_t - r.submit_t
                                             for r in reqs),
                decode_tok_s=(st.tokens_generated - tok0)
                / max(st.decode_time_s - dec0, 1e-9),
                wall_s=wall, tokens=[len(r.out_tokens) for r in reqs])


def _watch_resets(torch, eng) -> list:
    """Wrap the engine's rebuild: for each reset, the bytes allocated just
    before it and the peak allocated during it (the free-before-allocate
    repair keeps the peak at or under the bytes before)."""
    seen = []
    real = eng._reset_after_error

    def reset():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        real()
        torch.cuda.synchronize()
        seen.append(dict(before=before,
                         peak=torch.cuda.max_memory_allocated(),
                         after=torch.cuda.memory_allocated(),
                         rebuild_s=time.perf_counter() - t0))

    eng._reset_after_error = reset
    return seen


def _chain_fault(eng) -> dict:
    """A fetch that raises inside a burst chain (once): the second
    completion of a chained --decode-scan run raises, as a failing
    device-to-host copy would, while the chain's next burst is already
    dispatched. Returns its state (fired, and whether a burst was in
    flight)."""
    state = {"fired": False, "in_flight": None}
    real = eng._drive_burst

    def drive(dispatch, complete, can_chain):
        n = [0, 0]

        def counted_dispatch(s):
            n[1] += 1
            return dispatch(s)

        def failing_complete(devs):
            n[0] += 1
            if not state["fired"] and n[0] == 2:
                state["fired"] = True
                state["in_flight"] = n[1] - n[0]
                raise RuntimeError("smoke: a burst's fetch failed inside "
                                   "a chain")
            return complete(devs)

        return real(counted_dispatch, failing_complete, can_chain)

    eng._drive_burst = drive
    return state


def _guard_sync(torch, eng, graphs) -> tuple:
    """The silent injector's check: every fault-site test, decode
    dispatch, mixed replay, admission and page allocation runs under
    torch.cuda.set_sync_debug_mode("error"). Returns (the guarded call
    counts, an undo)."""
    guarded = Counter()

    def guard(name, fn):
        def wrapped(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                guarded[name] += 1
        return wrapped

    for name in ("_dispatch_scan", "_mixed_admit", "_alloc_slot_pages"):
        setattr(eng, name, guard(name, getattr(eng, name)))
    eng._faults.check = guard("site", eng._faults.check)
    real_run = graphs.MixedRunner.run
    graphs.MixedRunner.run = lambda self, *a: guard(
        "mixed replay", lambda *b: real_run(self, *b))(*a)

    def undo():
        graphs.MixedRunner.run = real_run
    return guarded, undo


def _recovery_served(torch, rpa, cfg, params, card: str) -> tuple:
    """Drive 1 (and 6): the bf16 weights (cut to CUT_LAYERS), 8 slots, the
    serve
    phase's 128 x 128 pool, --decode-scan 4, six chats of 64 tokens at
    once. Without a plan (cold and warm waves); with a never-firing plan
    armed at every site (cold wave, then the warm wave under
    set_sync_debug_mode("error")); with RECOVERY_PLAN and a fetch fault
    inside a burst chain (one cold wave): every chat 200, recoveries =
    the faults that fired, none quarantined, each reset's peak memory at
    or under what it held before. Returns (the ragged kernels' launches
    on the faulted wave, the record)."""
    import cake_tpu_torch.serve.graphs as graphs

    rec = {}
    srv = _SchedServer(torch, cfg, params, torch.bfloat16, False,
                       kv_pages=RECOVERY_PAGES)
    rec["plain_cold"] = _recovery_wave(srv, "Rc")
    rec["plain_warm"] = _recovery_wave(srv, "Rw")
    srv.close()
    del srv
    torch.cuda.empty_cache()

    srv = _SchedServer(torch, cfg, params, torch.bfloat16, False,
                       kv_pages=RECOVERY_PAGES, fault_plan=RECOVERY_SILENT)
    rec["silent_cold"] = _recovery_wave(srv, "Sc")
    guarded, undo = _guard_sync(torch, srv.engine, graphs)
    try:
        rec["silent_warm"] = _recovery_wave(srv, "Sw")
    finally:
        undo()
    eng = srv.engine
    if eng.stats.recoveries or eng._faults.describe()["injections_total"]:
        fail(f"recovery: the silent plan fired: {eng.recovery_state()}")
    if min(guarded[k] for k in ("site", "_dispatch_scan", "mixed replay",
                                "_mixed_admit", "_alloc_slot_pages")) <= 0:
        fail(f"recovery: the sync guard saw no call of a path: {guarded}")
    rec["silent_guarded_calls"] = dict(guarded)
    srv.close()
    del srv, eng
    torch.cuda.empty_cache()

    from cake_tpu_torch.faults import build_injector
    from cake_tpu_torch.obs import metrics as obs_metrics

    srv = _SchedServer(torch, cfg, params, torch.bfloat16, False,
                       kv_pages=RECOVERY_PAGES, fault_plan=RECOVERY_PLAN)
    eng = srv.engine
    in_place = hasattr(eng, "_reset_in_place")
    pool_bytes = eng.cache.memory_bytes()
    captures = []
    real_capture = eng.flight.count_capture
    resets = []
    eng.flight.count_capture = lambda fn, s: (
        captures.append((fn, len(resets))), real_capture(fn, s))
    # a warm wave with the plan disarmed captures every variant, so the
    # faulted wave compares with the plain server's warm wave and shows
    # whether a reset captures anew
    eng._faults = None
    rec["faulted_warmup"] = _recovery_wave(srv, "Rv")
    n_warm = len(captures)
    eng._faults = build_injector(_shift_steps(RECOVERY_PLAN,
                                              eng.stats.steps))
    resets = _watch_resets(torch, eng)
    chain = _chain_fault(eng)
    compiles0 = _metric_sum(obs_metrics.REGISTRY.render(),
                            "cake_jit_compiles_total")
    rpa.reset_launch_counts()
    rec["faulted"] = _recovery_wave(srv, "Rf")
    counts = {k: rpa.LAUNCHES[k] for k in ("rpa_decode", "rpa_mixed")}
    compiles1 = _metric_sum(obs_metrics.REGISTRY.render(),
                            "cake_jit_compiles_total")
    fired = eng._faults.describe()
    st = eng.stats
    want = fired["injections_total"] + int(chain["fired"])
    rec.update(
        plan=fired, chain_fault=chain, recoveries=st.recoveries,
        requests_recovered=st.requests_recovered, poisoned=st.poisoned,
        recovery_seconds=list(eng.recovery_seconds), resets=list(resets),
        pool_bytes=pool_bytes, captures_warmup=n_warm,
        captures_faulted=len(captures) - n_warm,
        compiles_before=compiles0, compiles_after=compiles1,
        launches=counts)
    n_faulted = len(resets)
    recoveries, poisoned = st.recoveries, st.poisoned
    if in_place:
        # the fallback rebuild, forced: the in-place reset raises, so
        # the free-before-allocate order meets the memory check
        def in_place_fails():
            raise RuntimeError("smoke: the in-place reset forced to fail")

        eng._reset_in_place = in_place_fails
        # a new fault episode: the faulted wave's resets leave the storm
        # window, so its breaker does not count them
        eng._reset_times.clear()
        eng._faults = build_injector(_shift_steps(RECOVERY_FALLBACK,
                                                  eng.stats.steps))
        c0 = len(captures)
        rec["fallback"] = _recovery_wave(srv, "Rb")
        rec["fallback_resets"] = resets[n_faulted:]
        rec["fallback_captures"] = len(captures) - c0
        if not rec["fallback_resets"]:
            fail("recovery: the forced fallback wave reset nothing")
    srv.close()
    if recoveries != want or poisoned or want < 3:
        fail(f"recovery: {recoveries} recoveries for {want} faults "
             f"({fired}, chain {chain}), {poisoned} quarantined")
    if not chain["fired"] or not chain["in_flight"]:
        fail(f"recovery: the chain fault did not land with a burst in "
             f"flight: {chain}")
    for k, n in counts.items():
        if n <= 0:
            fail(f"recovery: {k} never launched on the faulted wave")
    plain = {k: n for k, n in rpa.LAUNCHES.items()
             if k.endswith("_plain") and n}
    if plain:
        fail(f"recovery: plain versions ran: {plain}")
    log(f"recovery: {n_warm} graphs captured in the warm wave, "
        f"{rec['captures_faulted']} in the faulted wave; "
        f"cake_jit_compiles_total {compiles0:.0f} before it, "
        f"{compiles1:.0f} after [{card}]")
    if in_place and (rec["captures_faulted"] or compiles1 != compiles0):
        fail(f"recovery: the in-place resets captured "
             f"{rec['captures_faulted']} graphs anew (compiles "
             f"{compiles0:.0f} -> {compiles1:.0f})")
    for i, r in enumerate(resets):
        kind = "in place" if in_place and i < n_faulted else "rebuild"
        log(f"recovery: reset {i + 1} ({kind}): "
            f"{r['before'] / 2**30:.3f} GiB held, "
            f"peak {r['peak'] / 2**30:.3f} GiB during the rebuild, "
            f"{r['after'] / 2**30:.3f} GiB after (one pool "
            f"{pool_bytes / 2**30:.3f} GiB), rebuild {r['rebuild_s']:.3f} s "
            f"[{card}]")
        if r["peak"] > r["before"] + 0.1 * pool_bytes:
            fail(f"recovery: reset {i + 1} peaked "
                 f"{(r['peak'] - r['before']) / 2**30:.3f} GiB above what "
                 "it held: the old pool was still live")
    log(f"recovery: {recoveries} recoveries in "
        + ", ".join(f"{s:.3f}" for s in rec["recovery_seconds"])
        + f" s, {rec['requests_recovered']} requests resubmitted; faulted "
        f"(warm) wave TTFT p50 {rec['faulted']['ttft_p50_s']:.3f} s, decode "
        f"{rec['faulted']['decode_tok_s']:.1f} tok/s against "
        f"{rec['plain_warm']['ttft_p50_s']:.3f} s, "
        f"{rec['plain_warm']['decode_tok_s']:.1f} tok/s for the warm wave "
        f"without a plan [{card}]")
    if "fallback" in rec:
        log(f"recovery: forced fallback wave: "
            f"{len(rec['fallback_resets'])} rebuilds, "
            f"{rec['fallback_captures']} graphs captured anew, TTFT p50 "
            f"{rec['fallback']['ttft_p50_s']:.3f} s, decode "
            f"{rec['fallback']['decode_tok_s']:.1f} tok/s [{card}]")
    log(f"recovery: silent plan, warm wave {rec['silent_warm']['decode_tok_s']:.1f} "
        f"tok/s (TTFT p50 {rec['silent_warm']['ttft_p50_s']:.3f} s) against "
        f"{rec['plain_warm']['decode_tok_s']:.1f} tok/s "
        f"({rec['plain_warm']['ttft_p50_s']:.3f} s) without a plan; no sync "
        f"in {sum(guarded.values())} guarded calls [{card}]")
    del srv, eng
    torch.cuda.empty_cache()
    return counts, rec


def _f32_params(torch, cfg):
    """RECOVERY_LAYERS_F32 layers at cfg's width, f32 weights from a seed,
    the lm_head's columns past the byte range zeroed: greedy tokens stay
    in the ByteTokenizer's range (served text is not empty) and never hit
    an EOS id, so every stream runs to its budget."""
    import dataclasses

    from cake_tpu_torch.models.llama.params import init_params

    c = dataclasses.replace(cfg, num_hidden_layers=RECOVERY_LAYERS_F32)
    p = init_params(c, torch.Generator(device=DEV).manual_seed(15),
                    device=DEV, dtype=torch.float32)
    p["lm_head"][:, 256:] = 0.0
    return c, p


def _f32_engine(torch, cfg, params, **kw):
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    kw.setdefault("decode_scan_steps", 4)
    return InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), device=DEV,
        max_slots=8, max_seq_len=2048, kv_pages=RECOVERY_PAGES,
        kv_page_size=128, prefill_chunk=64, cache_dtype=torch.float32,
        sampling=SamplingConfig(temperature=0.0), recovery=True, **kw)


def _f32_prompts():
    return [[(7 * i + 3 * j) % 250 + 1 for j in range(n)]
            for i, n in enumerate(TIER_CHATS)]


def _run_prompts(eng, n_new: int = 32):
    hs = [eng.submit(p, max_new_tokens=n_new) for p in _f32_prompts()]
    with eng:
        for h in hs:
            if not h.wait(timeout=600):
                fail("recovery: a request did not finish")
    return hs


def _recovery_identity(torch, cfg32, p32, card: str) -> dict:
    """Drive 2: 8B width, 2 layers, f32 weights and pool, every prompt
    submitted before the engine starts: under RECOVERY_PLAN the greedy
    streams equal the same engine's without the plan, at decode_scan 4
    (decode_scan 1 cut for the smoke's time budget: its steps
    are the bursts' single replays). Returns the record (and the clean
    streams)."""
    rec = {}
    for scan in (4,):
        clean = [list(h._req.out_tokens) for h in _run_prompts(
            _f32_engine(torch, cfg32, p32, decode_scan_steps=scan))]
        eng = _f32_engine(torch, cfg32, p32, decode_scan_steps=scan,
                          fault_plan=RECOVERY_PLAN)
        hs = _run_prompts(eng)
        got = [list(h._req.out_tokens) for h in hs]
        fired = eng._faults.describe()["injections_total"]
        # no recovery seconds: the journal and device-fault children
        # share the card meanwhile (the served wave times recoveries)
        rec[f"scan{scan}"] = dict(recoveries=eng.stats.recoveries,
                                  fired=fired, identical=got == clean)
        if any(h._req.error for h in hs) or eng.stats.recoveries != fired \
                or fired != 3:
            fail(f"recovery identity (scan {scan}): {rec[f'scan{scan}']}")
        if got != clean:
            fail(f"recovery identity (scan {scan}): f32 greedy streams "
                 "differ from the run without the plan")
        rec["clean"] = clean
        log(f"recovery identity (f32, {RECOVERY_LAYERS_F32} layers, "
            f"decode_scan {scan}): {fired} faults, {eng.stats.recoveries} "
            f"recoveries, streams token-identical [{card}]")
    return rec


def _recovery_poison_breaker(torch, cfg32, p32, clean, card: str) -> dict:
    """Drive 3 and 5: the poison request through the HTTP API (a terminal
    500 for exactly that chat, 200 for the others), then drain on the
    same server (a 429 with Retry-After while the in-flight chats
    complete); the storm breaker with a snapshot, restored into a fresh
    engine token-identically."""
    from cake_tpu_torch.serve import checkpoint
    from cake_tpu_torch.serve.errors import RecoveryConfig

    rec = {}
    n_poison = TIER_CHATS[4]
    srv = _SchedServer(torch, cfg32, p32, torch.float32, False,
                       kv_pages=RECOVERY_PAGES,
                       fault_plan=f"seed=1;engine.prefill:match_len="
                                  f"{n_poison}:always:transient:times=50")
    names = [f"P{i}" for i in range(len(TIER_CHATS))]
    for name, n in zip(names, TIER_CHATS):
        srv.post(name, "standard", n, 32)
    srv.join()
    codes = {n: srv.status.get(n, (None,))[0] for n in names}
    want = {n: (500 if i == 4 else 200) for i, n in enumerate(names)}
    st = srv.engine.stats
    rec["poison"] = dict(codes=codes, poisoned=st.poisoned,
                         recoveries=st.recoveries)
    if codes != want or st.poisoned != 1:
        fail(f"recovery poison: {rec['poison']}, expected {want} and one "
             "quarantined")
    # drain: three chats in flight, then POST /api/v1/drain
    drain = [f"D{i}" for i in range(3)]
    for name in drain:
        srv.post(name, "standard", 200, 64)
    srv.wait_tokens(drain, 2)
    with _post(srv.url + "/api/v1/drain", {"timeout_s": 300}) as r:
        dst = json.loads(r.read())
    refused = None
    try:
        with _post(srv.url + "/api/v1/chat/completions",
                   {"messages": [{"role": "user", "content": "late"}],
                    "max_tokens": 4}) as r:
            refused = (r.status, None)
    except urllib.error.HTTPError as e:
        refused = (e.code, e.headers.get("Retry-After"))
    srv.join()
    dcodes = [srv.status.get(n, (None,))[0] for n in drain]
    rec["drain"] = dict(state=dst, refused=refused, in_flight=dcodes)
    if (refused[0] != 429 or not refused[1] or int(refused[1]) < 1
            or dcodes != [200] * 3 or not dst.get("draining")):
        fail(f"recovery drain: {rec['drain']}")
    log(f"recovery poison: {codes} ({st.recoveries} recoveries, "
        f"{st.poisoned} quarantined); drain: a late chat got "
        f"{refused[0]} Retry-After {refused[1]} s, the in-flight chats "
        f"{dcodes} [{card}]")
    srv.close()
    del srv

    # the storm breaker: resets from engine step 4 on (mid-prefill, some
    # first tokens out), 3 in the window
    import tempfile
    path = os.path.join(tempfile.mkdtemp(prefix="cake_smoke_"), "ckpt.json")
    eng = _f32_engine(torch, cfg32, p32, fault_plan="seed=2;engine.step:"
                      "step=4:transient:times=99",
                      recovery_config=RecoveryConfig(backoff_base_s=0.01,
                                                     storm_resets=3))
    eng.snapshot_path = path
    checkpoint.warm_fingerprint(eng)
    hs = _run_prompts(eng)
    recs = checkpoint.load(path)["requests"]
    ok = (eng._breaker_tripped and eng.stopped
          and [r["rid"] for r in recs] == [h._req.rid for h in hs]
          and all(checkpoint.is_resumable(r) for r in recs)
          and all(h._req.error is not None and h._req.error.retryable
                  for h in hs))
    fresh = _f32_engine(torch, cfg32, p32)
    with fresh:
        handles, finished = checkpoint.restore(fresh, path)
        for h in handles:
            if not h.wait(timeout=600):
                fail("recovery breaker: a restored request did not finish")
    joined = [list(r["out_tokens"]) + list(h._req.out_tokens)
              for r, h in zip(recs, handles)]
    rec["breaker"] = dict(tripped=eng._breaker_tripped,
                          recoveries=eng.stats.recoveries,
                          snapshot=len(recs), restored=len(handles),
                          generated_before=[len(r["out_tokens"])
                                            for r in recs],
                          identical=joined == clean)
    if not ok or finished or joined != clean:
        fail(f"recovery breaker: {rec['breaker']}")
    log(f"recovery breaker: tripped after {eng.stats.recoveries} "
        f"recoveries, snapshot of {len(recs)} requests, restored "
        f"token-identically [{card}]")
    return rec


def _journal_child(tree: str, jpath: str, plan: str) -> None:
    """A serving process for the cold-restart drive: the f32 2-layer
    model from the seed, --journal JPATH and the plan; prints its port,
    then serves until a drain (or the plan's abort) ends it."""
    import torch

    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.ops.sampling import SamplingConfig

    cfg32, p32 = _f32_params(
        torch, getattr(LlamaConfig, RECOVERY_CHILD_CONFIG)())
    args = Args(max_slots=8, max_seq_len=2048, kv_pages=RECOVERY_PAGES,
                kv_page_size=128, prefill_chunk=64, temperature=0.0,
                sample_len=32, journal=jpath,
                fault_plan=plan or None).validate()
    gen = LlamaGenerator(cfg32, p32, ByteTokenizer(cfg32.vocab_size),
                         max_seq_len=2048,
                         sampling=SamplingConfig(temperature=0.0),
                         cache_dtype=torch.float32, device=DEV)
    master = Master(args, text_generator=gen)
    engine = master.make_engine()
    httpd = start(master, "127.0.0.1:0", block=False, engine=engine)
    print(f"PORT {httpd.server_address[1]}", flush=True)
    while not engine.stopped:
        time.sleep(0.05)
    time.sleep(0.5)          # the drain's shutdown closes the server


def _spawn_child(jpath: str, plan: str, log_path: str):
    """A _journal_child process (this script's directory and the tree
    the parent imported on its path; its log to log_path): (the process,
    its URL)."""
    here = os.path.dirname(os.path.abspath(__file__))
    tree = sys.path[0]
    code = (f"import sys; sys.path.insert(0, {here!r}); "
            f"sys.path.insert(0, {tree!r}); import chip_smoke; "
            f"chip_smoke.DEV = {DEV!r}; "
            f"chip_smoke.RECOVERY_CHILD_CONFIG = {RECOVERY_CHILD_CONFIG!r}; "
            f"chip_smoke._journal_child({tree!r}, {jpath!r}, {plan!r})")
    err = open(log_path, "a")
    p = subprocess.Popen([sys.executable, "-c", code], cwd=here,
                         stdout=subprocess.PIPE, stderr=err, text=True)
    err.close()
    line = p.stdout.readline()
    if not line.startswith("PORT "):
        p.kill()
        p.wait()
        with open(log_path) as f:
            tail = f.read()[-3000:]
        fail(f"recovery journal: the child did not serve: {line!r} {tail}")
    return p, f"http://127.0.0.1:{int(line.split()[1])}"


def _sse_read(url: str, body: dict, headers: dict, until_drop: bool):
    """POST a streaming chat; the (event id, delta text) of its events.
    until_drop: the server dies mid-stream (the read ends in an error)."""
    req = urllib.request.Request(
        url + "/api/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **headers})
    events, cur, done = [], None, False
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            for raw in r:
                line = raw.decode().rstrip("\n")
                if line.startswith("id: "):
                    cur = int(line[4:])
                elif line == "data: [DONE]":
                    done = True
                elif line.startswith("data: "):
                    ev = json.loads(line[6:])
                    if "choices" in ev:
                        events.append(
                            (cur, ev["choices"][0]["delta"].get("content")))
                    cur = None
    except Exception as e:   # noqa: BLE001 — the child's abort
        if not until_drop:
            fail(f"recovery journal: the stream broke: {e!r}")
    return events, done


def _recovery_journal(torch, cfg32, p32, card: str):
    """Drive 4: a child process serves the f32 2-layer model with
    --journal and engine.decode:nth=10:abort; three keyed SSE chats
    stream until it dies with ABORT_EXIT_CODE. A second child on the same
    journal replays it; once it has finished the three requests, each
    client reconnects with its Last-Event-ID and receives exactly the
    missing suffix (one event, its id the stream's length). The joined
    streams (the second child's journal, replayed) equal an uninterrupted
    in-process run's tokens. The children's part runs on a thread while
    the caller's other drives run (the smoke's time budget); the
    returned function joins it and runs the in-process part."""
    got: dict = {}

    def children():
        try:
            got.update(_recovery_journal_children())
        except BaseException as e:      # noqa: BLE001 — a FAIL included
            got["error"] = e

    th = threading.Thread(target=children, daemon=True)
    th.start()

    def finish() -> dict:
        th.join(timeout=900)
        if "error" in got or th.is_alive():
            raise got.get("error") or SystemExit(
                "chip_smoke: FAIL: recovery journal: the children's part "
                "ran past 900 s")
        return _recovery_journal_check(torch, cfg32, p32, card, **got)
    return finish


def _recovery_journal_children() -> dict:
    """_recovery_journal's two children and their clients."""
    import tempfile

    from cake_tpu_torch.faults import ABORT_EXIT_CODE

    tmp = tempfile.mkdtemp(prefix="cake_smoke_journal_")
    jpath = os.path.join(tmp, "requests.journal")
    logp = os.path.join(tmp, "child.log")
    _NATIVE.update(journal=jpath)
    _NATIVE["child_logs"].append(logp)
    t0 = time.perf_counter()
    a, url = _spawn_child(jpath, RECOVERY_ABORT, logp)
    bodies = {k: {"messages": [{"role": "user",
                                "content": f"{k}: tell me a long story"}],
                  "max_tokens": 32, "temperature": 0.0, "stream": True}
              for k in RECOVERY_KEYS}
    seen = {}

    def client(k):
        seen[k] = _sse_read(url, bodies[k],
                            {"x-cake-idempotency-key": k}, True)

    threads = [threading.Thread(target=client, args=(k,))
               for k in RECOVERY_KEYS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    code = a.wait(timeout=120)
    last = {k: max([i for i, _ in seen[k][0] if i is not None] or [0])
            for k in RECOVERY_KEYS}
    if code != ABORT_EXIT_CODE or any(seen[k][1] for k in RECOVERY_KEYS):
        fail(f"recovery journal: the first child exited {code} (want "
             f"{ABORT_EXIT_CODE}); streams done {[seen[k][1] for k in seen]}")
    b, url = _spawn_child(jpath, "", logp)
    try:
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            h = json.loads(_get(url + "/api/v1/health"))
            if h["requests_completed"] >= len(RECOVERY_KEYS):
                break
            time.sleep(0.05)
        replay = h.get("journal", {}).get("last_replay", {})
        resumed = {}
        for k in RECOVERY_KEYS:
            resumed[k] = _sse_read(url, bodies[k],
                                   {"x-cake-idempotency-key": k,
                                    "Last-Event-ID": str(last[k])}, False)
        with _post(url + "/api/v1/drain", {"timeout_s": 60}) as r:
            r.read()
        code_b = b.wait(timeout=120)
    finally:
        if b.poll() is None:
            b.kill()
            b.wait()
    return dict(wall=time.perf_counter() - t0, jpath=jpath, bodies=bodies,
                last=last, replay=replay, resumed=resumed,
                codes=[code, code_b])


def _recovery_journal_check(torch, cfg32, p32, card, wall, jpath, bodies,
                            last, replay, resumed, codes) -> dict:
    """_recovery_journal's in-process part: the uninterrupted run, and
    each stream held against it."""
    from cake_tpu_torch.models.chat import Message
    from cake_tpu_torch.serve import journal as jr

    code = codes[0]
    states = {s["idempotency_key"]: s
              for s in jr.replay_state(jr.read_records(jpath)[0])[0]
              if s.get("idempotency_key")}
    # the uninterrupted run, in process
    eng = _f32_engine(torch, cfg32, p32, decode_scan_steps=1)
    with eng:
        hs = {k: eng.chat([Message.user(bodies[k]["messages"][0]
                                        ["content"])], max_new_tokens=32)
              for k in RECOVERY_KEYS}
        for h in hs.values():
            h.wait(timeout=600)
    tok = eng.tokenizer
    rec = dict(last_event_ids=last, replay=replay, exit_codes=codes,
               wall_s=wall)
    for k in RECOVERY_KEYS:
        full = list(states[k]["out_tokens"])
        want = list(hs[k]._req.out_tokens)
        events = resumed[k][0]
        text = [(i, t) for i, t in events if t]
        exp = tok.decode(full[last[k]:])
        ok = (full == want and resumed[k][1] and states[k].get("finished")
              and len(text) == 1 and text[0][0] == len(full)
              and text[0][1] == exp
              and all(i is None or i > last[k] for i, _ in events))
        rec[k] = dict(last=last[k], total=len(full), identical=full == want,
                      suffix_ok=ok)
        if not ok:
            fail(f"recovery journal {k}: last seen {last[k]}, events "
                 f"{events[:3]}..., journal tokens == uninterrupted "
                 f"{full == want}")
    if replay.get("replayed") != len(RECOVERY_KEYS):
        fail(f"recovery journal: the replay resubmitted {replay}")
    log(f"recovery journal: child exited {code} (abort) after "
        f"{list(last.values())} events; the second child replayed "
        f"{replay.get('replayed')} requests in {replay.get('seconds')} s; "
        f"each Last-Event-ID got exactly its suffix, streams "
        f"token-identical to an uninterrupted run; {wall:.1f} s [{card}]")
    return rec


def _device_fault_child(path: str, out: str) -> None:
    """A serving process for the device-fault drive: the f32 2-layer
    model, a snapshot path, and the third decode dispatch preceded by an
    out-of-range index on the card (a device-side assert: the context's
    sticky error). Writes what it saw to `out` as JSON."""
    import torch

    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.llama.config import LlamaConfig

    cfg32, p32 = _f32_params(
        torch, getattr(LlamaConfig, RECOVERY_CHILD_CONFIG)())
    eng = _f32_engine(torch, cfg32, p32, decode_scan_steps=1)
    raised = []

    def recorded(name):
        fn = getattr(eng, name)

        def call():
            try:
                return fn()
            except Exception as e:   # noqa: BLE001 — recorded, raised on
                raised.append([name, type(e).__name__, str(e)[:160]])
                raise
        return call

    for name in ("_reset_in_place", "_rebuild_after_error"):
        setattr(eng, name, recorded(name))
    calls = []
    dispatch = eng._dispatch_scan

    def faulting(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            x = torch.zeros(4, device=DEV)
            x[torch.tensor([1 << 20], device=DEV)] += 1.0
        return dispatch(*a, **k)

    eng._dispatch_scan = faulting
    died = []
    threading.excepthook = lambda args: died.append(repr(args.exc_value))
    master = Master(Args(sample_len=32, temperature=0.0),
                    text_generator=None)
    httpd = start(master, "127.0.0.1:0", block=False, engine=eng,
                  checkpoint_path=path)
    hs = [eng.submit(p, max_new_tokens=32) for p in _f32_prompts()]
    ok = all(h.wait(timeout=300) for h in hs)
    eng._thread.join(timeout=60)
    health = json.loads(_get(f"http://127.0.0.1:{httpd.server_address[1]}"
                             "/api/v1/health"))
    with open(out, "w") as f:
        json.dump(dict(
            ok=ok, died=died, raised=raised, stopped=eng.stopped,
            last_error=eng.stats.last_error, health=health.get("status"),
            errors=[type(h._req.error).__name__ for h in hs],
            retryable=[bool(getattr(h._req.error, "retryable", False))
                       for h in hs]), f)
    httpd.shutdown()
    # the context is dead: leave without its teardown
    os._exit(0)


def _recovery_device_fault(torch, cfg32, p32, card: str):
    """Drive 6: a real device fault. A child process serves the f32
    2-layer model and trips a device-side assert before a decode
    dispatch: its in-place reset and its fallback rebuild both raise
    (the context is dead), so the engine stops with reset_failed, health
    reads "stopped", every client gets a retryable error, and the
    snapshot is written without a device read. This process resumes the
    snapshot into a fresh engine: the joined streams equal an
    uninterrupted run's (f32). Returns, once the child is started, a
    function of the uninterrupted streams that joins and checks it."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="cake_smoke_fault_")
    path, out = os.path.join(tmp, "ckpt.json"), os.path.join(tmp, "out.json")
    here, tree = os.path.dirname(os.path.abspath(__file__)), sys.path[0]
    code = (f"import sys; sys.path.insert(0, {here!r}); "
            f"sys.path.insert(0, {tree!r}); import chip_smoke; "
            f"chip_smoke.DEV = {DEV!r}; "
            f"chip_smoke.RECOVERY_CHILD_CONFIG = {RECOVERY_CHILD_CONFIG!r}; "
            f"chip_smoke._device_fault_child({path!r}, {out!r})")
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-c", code], cwd=here,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    # the caller's other drives run while the child serves and faults
    # (the smoke's time budget); `clean` is theirs
    return lambda clean: _recovery_device_fault_end(
        torch, cfg32, p32, clean, card, child, path, out, t0)


def _recovery_device_fault_end(torch, cfg32, p32, clean, card, child, path,
                               out, t0) -> dict:
    """_recovery_device_fault's child joined, its snapshot resumed."""
    from cake_tpu_torch.serve import checkpoint

    try:
        _, stderr = child.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        child.kill()
        fail("recovery device fault: the child ran past 300 s")
    r = subprocess.CompletedProcess(child.args, child.returncode, "", stderr)
    if not os.path.exists(out):
        fail(f"recovery device fault: the child wrote nothing (exit "
             f"{r.returncode}):\n{r.stderr[-3000:]}")
    with open(out) as f:
        got = json.load(f)
    recs = checkpoint.load(path)["requests"]
    asserted = any("assert" in m.lower() for _, _, m in got["raised"])
    ok = (got["ok"] and not got["died"] and got["stopped"]
          and [n for n, _, _ in got["raised"]] == ["_reset_in_place",
                                                   "_rebuild_after_error"]
          and got["last_error"] == "reset failed"
          and got["health"] == "stopped"
          and set(got["errors"]) == {"EngineResetError"}
          and all(got["retryable"]) and len(recs) == len(clean)
          and all(checkpoint.is_resumable(x) for x in recs))
    if not ok:
        fail(f"recovery device fault: {got}, {len(recs)} snapshotted")
    fresh = _f32_engine(torch, cfg32, p32)
    with fresh:
        handles, finished = checkpoint.restore(fresh, path)
        for h in handles:
            if not h.wait(timeout=600):
                fail("recovery device fault: a resumed request did not "
                     "finish")
    joined = [list(x["out_tokens"]) + list(h._req.out_tokens)
              for x, h in zip(recs, handles)]
    rec = dict(raised=got["raised"], device_assert=asserted,
               health=got["health"], errors=got["errors"],
               generated_before=[len(x["out_tokens"]) for x in recs],
               identical=joined == clean, finished=len(finished),
               wall_s=time.perf_counter() - t0)
    if finished or joined != clean:
        fail(f"recovery device fault: the resumed streams differ: {rec}")
    log(f"recovery device fault: the child's in-place reset raised "
        f"{got['raised'][0][1]} ({got['raised'][0][2][:60]!r}), the "
        f"rebuild {got['raised'][1][1]}; reset_failed, health "
        f"{got['health']}, {len(got['errors'])} clients errored "
        f"(retryable), snapshot of {len(recs)} requests "
        f"({rec['generated_before']} tokens out) resumed token-identically "
        f"in this process; {rec['wall_s']:.1f} s [{card}]")
    return rec


def phase_recovery(torch, rpa, cfg, params, card: str) -> tuple:
    """Fault injection, crash recovery, the checkpoint, the journal and
    drain at Llama-3-8B width (drives 2-5: 2 layers, f32). Returns (the
    ragged kernels' launches on the faulted wave, the phase's record)."""
    t_phase = time.perf_counter()
    counts, rec = _recovery_served(torch, rpa, cfg, params, card)
    cfg32, p32 = _f32_params(torch, cfg)
    from cake_tpu_torch.serve.engine import InferenceEngine
    fault_done = (_recovery_device_fault(torch, cfg32, p32, card)
                  if hasattr(InferenceEngine, "_reset_in_place") else None)
    journal_done = _recovery_journal(torch, cfg32, p32, card)
    rec["identity"] = _recovery_identity(torch, cfg32, p32, card)
    clean = rec["identity"].pop("clean")
    rec.update(_recovery_poison_breaker(torch, cfg32, p32, clean, card))
    rec["journal"] = journal_done()
    if fault_done is not None:
        rec["device_fault"] = fault_done(clean)
    del p32
    torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t_phase
    log(f"recovery: phase wall {rec['wall_s']:.1f} s [{card}]")
    return counts, rec


# -- spec: paged speculative decoding and the batch-1 draft generator ---------

SPEC_GAMMA_ID = 3            # (a): the identity drives' gamma
SPEC_GAMMA = 4               # (b): full width
SPEC_NEW_ID = 24             # (a): tokens a stream
SPEC_NEW = 64                # (b): tokens a chat
SPEC_PROMPTS_ID = (40, 100, 70)
SPEC_C = (2, 5)              # verify windows held against the plain bodies


def _spec_kernel_checks(torch, rpa, fa, i4) -> dict:
    """The bodies the spec path launches at its own shapes, each against
    its plain version on the card: the mixed body (bf16, 8B heads) and
    its merge at verify windows C = 2 and 5, the window writer's targets
    at the same C against a position-by-position scatter, the split
    decode body and flash at the 1B draft's hd = 64, and int4_matmul at
    the verify's B x (gamma + 1) = 40 rows."""
    from cake_tpu_torch.models.llama.paged import (
        PagedKVCache, step_write_targets, write_windows_pages,
    )
    from cake_tpu_torch.ops.quant import group_size, quantize_group

    gen = torch.Generator(device="cuda").manual_seed(17)
    dev, bf = "cuda", torch.bfloat16
    B, H, KV, P, MP, N = 8, 32, 8, 128, 16, 128
    rec = {}
    tol = TOL["bfloat16"]

    def hold(label, got, want):
        err = (got.float() - want.float()).abs().max().item()
        if not torch.isfinite(got.float()).all() or not torch.allclose(
                got.float(), want.float(), **tol):
            fail(f"spec kernels: {label}: max |kernel - plain| {err:.3e} "
                 f"over {tol}")
        rec[label] = err
        log(f"spec kernels: {label}: max_abs_err {err:.3e} (tol {tol})")

    table = torch.randperm(N, generator=gen, device=dev).to(
        torch.int32).reshape(B, MP)
    pos = torch.tensor([2047 - 5, 127, 5 * P + 126, 300, 0, 9 * P + 124,
                        1000, 400], dtype=torch.int32, device=dev)
    for hd in (128, 64):
        pk, pv = (torch.randn((N, P, KV, hd), generator=gen, device=dev,
                              dtype=bf) for _ in range(2))
        if hd == 128:
            for C in SPEC_C:
                q = torch.randn((B, C, H, hd), generator=gen, device=dev,
                                dtype=bf)
                q_len = torch.full((B,), C, dtype=torch.int32, device=dev)
                q_len[3] = 0
                kw = dict(table=table, pos=pos, q_len=q_len)
                hold(f"rpa_mixed C={C} hd={hd} "
                     f"({_mixed_body(rpa, q, pk, pv, {}, MP, P)})",
                     rpa.ragged_paged_attention_mixed(q, pk, pv, **kw),
                     rpa.ragged_paged_attention_mixed_plain(q, pk, pv, **kw))
        q = torch.randn((B, 1, H, hd), generator=gen, device=dev, dtype=bf)
        hold(f"rpa_decode hd={hd}",
             rpa.ragged_paged_attention(q, pk, pv, table, pos),
             rpa.ragged_paged_attention_plain(q, pk, pv, table, pos))
        if hd == 64:
            qf = torch.randn((1, 256, H, hd), generator=gen, device=dev,
                             dtype=bf)
            kf, vf = (torch.randn((1, 256, KV, hd), generator=gen,
                                  device=dev, dtype=bf) for _ in range(2))
            hold(f"flash_attn S=256 hd={hd}", fa.flash_attention(qf, kf, vf),
                 fa.flash_attention_plain(qf, kf, vf))
    # the window writer at the verify widths: fixed-shape targets (the
    # sink where JAX drops) against a scatter position by position
    from cake_tpu_torch.models.llama.config import LlamaConfig
    cfg_w = LlamaConfig(num_hidden_layers=1)       # KV 8, hd 128
    for C in SPEC_C:
        cache = PagedKVCache.create(cfg_w, B, N, P, MP * P, dtype=bf,
                                    device=dev)
        cache.table.copy_(table)
        cache.table[2, 6] = -1           # a window crossing onto a hole
        q_len = torch.full((B,), C, dtype=torch.int32, device=dev)
        q_len[3] = 0
        active = q_len > 0
        k, v = (torch.randn((B, C, KV, 128), generator=gen, device=dev,
                            dtype=bf) for _ in range(2))
        pk, pv = cache.layer(0)
        write_windows_pages(pk, pv, k, v, pos, q_len, active, cache.table,
                            step_write_targets(cache, pos, active, q_len, C))
        want = torch.zeros_like(cache.k[0])
        for b in range(B):
            for c in range(int(q_len[b])):
                t = int(pos[b]) + c
                page = int(cache.table[b, t // P]) if t // P < MP else -1
                if page >= 0:
                    want[page, t % P] = k[b, c]
        if not torch.equal(cache.k[0], want):
            fail(f"spec kernels: the window writer at C={C} wrote other "
                 "pages than the position-by-position scatter")
        log(f"spec kernels: window writer C={C}: pages equal to the "
            "position-by-position scatter (a hole, an idle row)")
    # int4_matmul at the verify's rows (8 rows x gamma + 1)
    M = B * (SPEC_GAMMA + 1)
    In, Out = INT4_MAIN
    qt = quantize_group(torch.randn((In, Out), generator=gen, device=dev)
                        * In ** -0.5, 0)
    x = torch.randn((M, In), generator=gen, device=dev).to(bf)
    hold(f"int4_matmul M={M}", i4.int4_matmul(x, qt.q, qt.scale,
                                              g=group_size(qt)),
         i4.int4_matmul_plain(x, qt.q, qt.scale, g=group_size(qt)))
    return rec


def _spec_draft_f32(torch, cfg32):
    """(a)'s mismatched draft: one layer at the same width, another seed,
    the lm_head past the byte range zeroed as `_f32_params` does."""
    import dataclasses

    from cake_tpu_torch.models.llama.params import init_params

    c = dataclasses.replace(cfg32, num_hidden_layers=1)
    p = init_params(c, torch.Generator(device=DEV).manual_seed(16),
                    device=DEV, dtype=torch.float32)
    p["lm_head"][:, 256:] = 0.0
    return c, p


def _spec_f32_engine(torch, cfg, params, device, draft=None, **kw):
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    if draft is not None:
        kw.update(spec_draft_params=draft[1], spec_draft_config=draft[0],
                  spec_gamma=SPEC_GAMMA_ID)
    return InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), device=device,
        max_slots=4, max_seq_len=1024, kv_pages=32, kv_page_size=128,
        prefill_chunk=64, cache_dtype=torch.float32,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        recovery=True, **kw)


def _spec_streams(eng, prompts, n_new: int):
    """Every prompt submitted before the engine starts; the greedy
    streams, after the pool's conservation is checked."""
    hs = [eng.submit(list(p), max_new_tokens=n_new, temperature=0.0,
                     repeat_penalty=1.0) for p in prompts]
    with eng:
        for h in hs:
            if not h.wait(timeout=900) or h._req.error is not None:
                fail(f"spec: a stream did not finish ({h._req.error})")
    pg = eng._pager
    if pg.free_pages + pg.live_pages != pg.n_pages or pg.live_pages:
        fail(f"spec: pool not conserved: free {pg.free_pages} + live "
             f"{pg.live_pages} != {pg.n_pages}")
    if eng._specp is not None and eng._specp.spec_streams:
        fail("spec: spec states survived their streams")
    return [list(h._req.out_tokens) for h in hs]


def _spec_identity(torch, card: str) -> dict:
    """(a) 8B width, 2 layers, f32 params and pool: the card's spec engine
    (self-draft and a mismatched 1-layer draft, gamma 3) against the
    card's plain engine and the CPU's spec engine, token for token; a
    spec.verify:always storm degrades every stream with an event and
    finishes it exactly; across an in-place recovery the round captures
    nothing anew. Then the batch-1 generator: SpeculativeGenerator on
    the card equal to greedy LlamaGenerator, and one spec_scan of R = 4
    chained replays equal to four single rounds."""
    import numpy as np

    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.models.llama.speculative import SpeculativeGenerator
    from cake_tpu_torch.ops.sampling import SamplingConfig

    cfg32, p32 = _f32_params(torch, LlamaConfig.llama3_8b())
    draft = _spec_draft_f32(torch, cfg32)
    prompts = [[(7 * i + 3 * j) % 250 + 1 for j in range(n)]
               for i, n in enumerate(SPEC_PROMPTS_ID)]
    cpu = {k: v.cpu() if hasattr(v, "cpu") else v
           for k, v in p32.items() if k != "blocks"}
    cpu["blocks"] = {k: v.cpu() for k, v in p32["blocks"].items()}
    cpu_d = {k: v.cpu() for k, v in draft[1].items() if k != "blocks"}
    cpu_d["blocks"] = {k: v.cpu() for k, v in draft[1]["blocks"].items()}
    plain = _spec_streams(_spec_f32_engine(torch, cfg32, p32, DEV), prompts,
                          SPEC_NEW_ID)
    rec = {}
    for name, d, dc in (("self", (cfg32, p32), (cfg32, cpu)),
                        ("mismatched", draft, (draft[0], cpu_d))):
        eng = _spec_f32_engine(torch, cfg32, p32, DEV, draft=d)
        got = _spec_streams(eng, prompts, SPEC_NEW_ID)
        ref = _spec_streams(_spec_f32_engine(torch, cfg32, cpu, "cpu",
                                             draft=dc), prompts, SPEC_NEW_ID)
        st = eng.stats
        rec[name] = dict(proposed=st.spec_proposed, accepted=st.spec_accepted,
                         plain=got == plain, cpu=got == ref)
        log(f"spec identity ({name} draft, f32, 2 layers, gamma "
            f"{SPEC_GAMMA_ID}): {st.spec_accepted}/{st.spec_proposed} "
            f"drafts accepted; streams == plain engine {got == plain}, == "
            f"CPU spec engine {got == ref} [{card}]")
        if got != plain or got != ref or not st.spec_proposed:
            fail(f"spec identity ({name}): {rec[name]}")
    # a spec.verify storm: every stream degrades and finishes exactly
    eng = _spec_f32_engine(torch, cfg32, p32, DEV, draft=(cfg32, p32),
                           fault_plan=("seed=1;spec.verify:always:transient"
                                       ":times=64"))
    got = _spec_streams(eng, prompts, SPEC_NEW_ID)
    deg = eng.events.dump(type="spec_degraded")
    rids = {e["rid"] for e in deg if e["action"] == "disabled"}
    rec["storm"] = dict(degraded=len(rids), identical=got == plain)
    log(f"spec identity (spec.verify:always): {len(rids)} streams degraded "
        f"({sorted({e['reason'] for e in deg})}), streams == plain "
        f"{got == plain}")
    if got != plain or len(rids) != len(prompts):
        fail(f"spec identity (storm): {rec['storm']}")
    # an in-place recovery in the middle of the spec rounds
    eng = _spec_f32_engine(torch, cfg32, p32, DEV, draft=(cfg32, p32),
                           fault_plan="seed=3;engine.step:nth=5:transient")
    seen = []
    real_reset = eng._reset_in_place

    def reset():
        seen.append(eng._spec_runner and eng._spec_runner.captures)
        real_reset()
    eng._reset_in_place = reset
    got = _spec_streams(eng, prompts, SPEC_NEW_ID)
    after = eng._spec_runner.captures
    rec["recovery"] = dict(recoveries=eng.stats.recoveries, before=seen,
                           after=after, identical=got == plain)
    log(f"spec identity (in-place recovery): {eng.stats.recoveries} "
        f"recoveries, round captures {seen} before the reset, {after} "
        f"after; streams == plain {got == plain}")
    if (got != plain or eng.stats.recoveries != 1 or not seen
            or not seen[0] or after != seen[0]):
        fail(f"spec identity (recovery): {rec['recovery']}")
    # the batch-1 generator, self-draft
    greedy = SamplingConfig(temperature=0.0, repeat_penalty=1.0)
    tok = ByteTokenizer(cfg32.vocab_size)
    prompt = np.asarray([prompts[1]], np.int32)
    plen = np.asarray([len(prompts[1])], np.int32)
    want = LlamaGenerator(cfg32, p32, tok, max_seq_len=1024, sampling=greedy,
                          cache_dtype=torch.float32, device=DEV
                          ).generate_on_device(prompt, plen, SPEC_NEW_ID)
    outs = []
    for R in (4, 1):
        sg = SpeculativeGenerator(cfg32, p32, draft[0], draft[1], tok,
                                  gamma=SPEC_GAMMA_ID, max_seq_len=1024,
                                  sampling=greedy, cache_dtype=torch.float32,
                                  spec_rounds=R, device=DEV)
        got = sg.generate_on_device(prompt, plen, SPEC_NEW_ID)
        r, first = sg._runner, sg._prefill_both(sg._runner, prompts[1])
        rounds, last, pos = [], first, len(prompts[1])
        for _ in range(4 // R):
            o, n = sg._rounds(r, last, pos, R)
            for k in range(R):
                rounds.append((o[k, :n[k]].tolist(), int(n[k])))
                last, pos = int(o[k, n[k] - 1]), pos + int(n[k])
        outs.append(rounds)
        if not np.array_equal(got, want):
            fail(f"spec identity (generator, R={R}): the stream differs "
                 "from greedy LlamaGenerator's")
    rec["generator"] = dict(scan_equals_single=outs[0] == outs[1])
    log(f"spec identity (generator, mismatched draft): == greedy "
        f"LlamaGenerator; one spec_scan of 4 replays == 4 single rounds "
        f"{outs[0] == outs[1]}")
    if outs[0] != outs[1]:
        fail("spec identity: R = 4 chained replays differ from 4 rounds")
    return rec


def _cut_draft(cfg, params, layers: int):
    """The target's first `layers` blocks with its embedding, final norm
    and lm_head (views, no copy)."""
    import dataclasses
    c = dataclasses.replace(cfg, num_hidden_layers=layers)
    p = {k: v for k, v in params.items() if k != "blocks"}
    p["blocks"] = {k: v[:layers] for k, v in params["blocks"].items()}
    return c, p


SPEC_1B_LAYERS = 2           # (b): the 1B-shaped draft's depth (of 16)


def _llama32_1b(torch, layers: int = SPEC_1B_LAYERS):
    """A Llama-3.2-1B-shaped random bf16 draft (meta-llama/Llama-3.2-1B's
    published config.json: D 2048, H 32, KV 8, hd 64, F 8192, V 128256,
    tied embeddings), its 16 layers cut to `layers`."""
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.params import init_params

    c = LlamaConfig(vocab_size=128256, hidden_size=2048,
                    intermediate_size=8192, num_hidden_layers=layers,
                    num_attention_heads=32, num_key_value_heads=8,
                    rope_theta=500000.0, max_position_embeddings=131072,
                    tie_word_embeddings=True)
    return c, init_params(c, torch.Generator(device="cuda").manual_seed(1),
                          device="cuda", dtype=torch.bfloat16)


def _spec_wave(torch, eng, prompts, label: str, measured: bool = True):
    """One wave of the engine: the chats at once, wall and tok/s, the
    captures inside it (none allowed in a measured wave), and for a spec
    engine its rounds' device ms beside their bound (the engine's
    counted bytes at 3.35 TB/s), acceptance and events."""
    caps, costs = [], []
    real_cap = eng.flight.count_capture
    eng.flight.count_capture = lambda fn, sec: (caps.append(fn),
                                                real_cap(fn, sec))
    if eng._specp is not None:
        real_cost = eng._spec_cost

        def cost(pr, g):
            c = real_cost(pr, g)
            costs.append(c.bytes_accessed)
            return c
        eng._spec_cost = cost
        p0, a0 = eng.stats.spec_proposed, eng.stats.spec_accepted
    recs0 = eng.flight.dump(1)
    step0 = recs0[0]["step"] if recs0 else -1
    t0 = time.perf_counter()
    hs = [eng.submit(list(p), max_new_tokens=SPEC_NEW, temperature=0.0,
                     repeat_penalty=1.0) for p in prompts]
    for h in hs:
        if not h.wait(timeout=900) or h._req.error is not None:
            fail(f"spec {label}: a chat did not finish ({h._req.error})")
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    eng.flight.count_capture = real_cap
    toks = sum(len(h._req.out_tokens) for h in hs)
    recs = [r for r in eng.flight.dump() if r["step"] > step0]
    rec = dict(label=label, tokens=toks, wall_s=wall, tok_s=toks / wall,
               captures=len(caps))
    pg = eng._pager
    if pg.free_pages + pg.live_pages != pg.n_pages:
        fail(f"spec {label}: pool not conserved")
    if caps and measured:
        fail(f"spec {label}: {caps} captured inside the measured wave")
    if eng._specp is not None:
        eng._spec_cost = real_cost
        sp = eng._specp
        spec = [r for r in recs if r["kind"] == "spec"]
        dev_ms = (1e3 * statistics.mean(r["device_s"] for r in spec)
                  if spec else None)
        bound = (1e3 * statistics.mean(costs) / HBM_BYTES_PER_S
                 if costs else None)
        deg = Counter(e["action"] for e in eng.events.dump(
            type="spec_degraded"))
        prop = eng.stats.spec_proposed - p0
        acc = eng.stats.spec_accepted - a0
        rec.update(rounds=len(spec), round_ms=dev_ms, round_bound_ms=bound,
                   accepted=acc, proposed=prop,
                   acceptance=acc / prop if prop else None,
                   accept_ema=sp.accept_ema, tokens_per_round=sp.tokens_ema,
                   gamma=sp.live_gamma, degraded=dict(deg))
    return rec


def _spec_full(torch, rpa, fa, cfg, params, card: str):
    """(b) Llama-3-8B width and depth, the phases' bf16 weights: 128 x
    128-token pages, 8 slots, six chats of SPEC_NEW tokens at
    repeat_penalty 1.0, gamma 4, against the plain engine in the same
    call; drafts: the target itself and a
    Llama-3.2-1B-shaped random draft at SPEC_1B_LAYERS of its 16 layers
    (hd 64: the draft pool and rounds at another head width). Random
    weights decide acceptance here: it is printed, not gated. Then the
    batch-1 generator with a self-draft at 4096 slots, R = 4, beside the
    plain generator."""
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    prompts = [[(11 * i + 5 * j) % 30000 + 1000 for j in range(n)]
               for i, n in enumerate(TIER_CHATS)]
    greedy = SamplingConfig(temperature=0.0, repeat_penalty=1.0)

    def engine(draft=None, p=params):
        kw = {}
        if draft is not None:
            kw = dict(spec_draft_params=draft[1], spec_draft_config=draft[0],
                      spec_gamma=SPEC_GAMMA)
        return InferenceEngine(
            cfg, p, ByteTokenizer(cfg.vocab_size), device="cuda",
            max_slots=8, max_seq_len=2048, kv_pages=RECOVERY_PAGES,
            kv_page_size=128, cache_dtype=torch.bfloat16, sampling=greedy,
            decode_scan_steps=4, **kw)

    def warm(eng, label):
        """Warm-up waves until one captures nothing (the tuner's gamma
        shrinks are new graphs, as JAX compiles per gamma), at most 4."""
        for i in range(4):
            w = _spec_wave(torch, eng, prompts, f"{label} (warm-up {i})",
                           measured=False)
            if not w["captures"]:
                return
        fail(f"spec {label}: still capturing after 4 warm-up waves")

    def drive(eng, label):
        with eng:
            warm(eng, label)
            return _spec_wave(torch, eng, prompts, label)

    records = [drive(engine(), "plain")]
    counts = None
    # the target's first four blocks as a draft, cut for the
    # smoke's time budget (the 1B-shaped draft is the mismatched one)
    drafts = (("self", lambda: (cfg, params)),
              ("llama3.2-1b", lambda: _llama32_1b(torch)))
    for name, make in drafts:
        d = make()
        eng = engine(d)
        gib = eng.d_cache.memory_bytes() / 2**30
        with eng:
            warm(eng, name)
            for m in (rpa, fa):
                m.reset_launch_counts()
            r = _spec_wave(torch, eng, prompts, name)
            if counts is None:
                counts = {**rpa.LAUNCHES, **fa.LAUNCHES}
        r.update(draft_pool_gib=gib, target_pool_gib=(
            eng.cache.memory_bytes() / 2**30))
        records.append(r)
        del eng, d
        torch.cuda.empty_cache()
    for r in records:
        extra = ("" if "rounds" not in r else
                 f"; {r['rounds']} rounds, round {r['round_ms']:.3f} ms "
                 f"(bound {r['round_bound_ms']:.3f} ms), acceptance "
                 f"{r['acceptance']}, EMA {r['accept_ema']}, tokens/round "
                 f"EMA {r['tokens_per_round']}, gamma {r['gamma']}, "
                 f"degraded {r['degraded']}, draft pool "
                 f"{r['draft_pool_gib']:.3f} GiB")
        log(f"spec full width {r['label']:<12}: {r['tokens']} tokens in "
            f"{r['wall_s']:.2f} s = {r['tok_s']:.1f} tok/s, captures "
            f"{r['captures']}{extra} [{card}]")
    plain = [k for k in counts if k.endswith("_plain") and counts[k]]
    if plain or not counts.get("rpa_decode") or not counts.get("rpa_mixed"):
        fail(f"spec: launches of the self-draft wave {counts}")
    return counts, records


def _spec_int4(torch, i4, cfg, q4, card: str) -> dict:
    """The self-draft engine over int4 target weights: the verify's
    B x (gamma + 1) <= 64-row products launch int4_matmul."""
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    prompts = [[(11 * i + 5 * j) % 30000 + 1000 for j in range(n)]
               for i, n in enumerate(TIER_CHATS)]
    eng = InferenceEngine(
        cfg, q4, ByteTokenizer(cfg.vocab_size), device="cuda", max_slots=8,
        max_seq_len=2048, kv_pages=RECOVERY_PAGES, kv_page_size=128,
        cache_dtype=torch.bfloat16,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        decode_scan_steps=4, spec_draft_params=q4, spec_draft_config=cfg,
        spec_gamma=SPEC_GAMMA)
    with eng:
        for i in range(4):
            if not _spec_wave(torch, eng, prompts, f"int4 self (warm-up {i})",
                              measured=False)["captures"]:
                break
        i4.reset_launch_counts()
        r = _spec_wave(torch, eng, prompts, "int4 self")
        got = dict(i4.LAUNCHES)
    r["int4_matmul"] = got.get("int4_matmul", 0)
    log(f"spec int4 weights (self-draft): {r['tokens']} tokens, "
        f"{r['tok_s']:.1f} tok/s, {r['rounds']} rounds, round "
        f"{r['round_ms']:.3f} ms (bound {r['round_bound_ms']:.3f} ms), "
        f"int4_matmul launches {got} [{card}]")
    if not got.get("int4_matmul") or got.get("int4_matmul_plain"):
        fail(f"spec int4: launches {got}")
    return r


def _spec_generator(torch, cfg, params, card: str) -> dict:
    """The batch-1 generator at full width with a self-draft (4096 slots,
    R = 4, gamma 4): a 1000-token prompt and SPEC_NEW greedy tokens
    through Master.generate_text, beside the plain LlamaGenerator's
    tok/s; a round replay's device ms beside its bound (the draft's
    weights gamma + 1 times, the target's once, and the KV up to the
    frontier, at 3.35 TB/s)."""
    import dataclasses

    from cake_tpu_torch.args import Args
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.chat import Message
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.models.llama.params import params_bytes
    from cake_tpu_torch.models.llama.speculative import SpeculativeGenerator
    from cake_tpu_torch.ops.sampling import SamplingConfig

    fcfg = dataclasses.replace(cfg, use_flash_attention=True)
    tok = ByteTokenizer(cfg.vocab_size)
    greedy = SamplingConfig(temperature=0.0, repeat_penalty=1.0)
    system = "You are a helpful AI assistant."
    out = {}
    for name in ("plain", "spec"):
        if name == "plain":
            g = LlamaGenerator(fcfg, params, tok, max_seq_len=4096,
                               sampling=greedy, cache_dtype=torch.bfloat16)
        else:
            g = SpeculativeGenerator(fcfg, params, fcfg, params, tok,
                                     gamma=SPEC_GAMMA, max_seq_len=4096,
                                     sampling=greedy,
                                     cache_dtype=torch.bfloat16,
                                     spec_rounds=4)
        m = Master(Args(sample_len=SPEC_NEW, system_prompt=system),
                   text_generator=g)
        for n_prompt in (300, 1000):          # warm-up, then measured
            m.reset()
            m.add_message(Message.system(system))
            m.add_message(Message.user(_prompt_of(tok, n_prompt, system)))
            m.generate_text(lambda t: None)
        out[name] = dict(tok_s=m.tokens_per_s, tokens=len(g.tokens))
        if name == "spec":
            r = g._runner
            ms = r.timing[0].elapsed_time(r.timing[1]) / r.ns.numel()
            pos = g.index_pos
            kv = (2 * cfg.num_hidden_layers * cfg.num_key_value_heads
                  * cfg.head_dim * 2)
            need = (params_bytes(params) * (SPEC_GAMMA + 2)
                    + kv * (SPEC_GAMMA + 2) * pos)
            out[name].update(round_ms=ms,
                             bound_ms=need / HBM_BYTES_PER_S * 1e3,
                             acceptance=g.acceptance_rate,
                             captures=r.captures)
    s = out["spec"]
    log(f"spec generator (self-draft, 8B bf16, R=4): {s['tok_s']:.1f} tok/s "
        f"vs plain {out['plain']['tok_s']:.1f}; round replay "
        f"{s['round_ms']:.3f} ms (bound {s['bound_ms']:.3f} ms), "
        f"acceptance {s['acceptance']:.3f}, captures {s['captures']} "
        f"[{card}]")
    if s["tokens"] < 1 or s["captures"] != 1:
        fail(f"spec generator: {out}")
    return out


def phase_spec(torch, rpa, fa, i4, cfg, params, card: str):
    """The spec phase: the kernels at the spec path's shapes, (a) the f32
    identities, (b) full width. Returns (launch counts of the measured
    self-draft wave, record)."""
    t0 = time.perf_counter()
    rec = dict(kernels=_spec_kernel_checks(torch, rpa, fa, i4))
    rec["identity"] = _spec_identity(torch, card)
    torch.cuda.empty_cache()
    counts, rec["full"] = _spec_full(torch, rpa, fa, cfg, params, card)
    rec["generator"] = _spec_generator(torch, cfg, params, card)
    log(f"spec phase: {time.perf_counter() - t0:.1f} s")
    return counts, rec


# -- the control phase: live reconfiguration and the obs/ control plane ------

CONTROL_NEW = 64                  # tokens a chat in (1)
# (1)'s server flags, and the configs its POSTs switch to
CONTROL_A = dict(slots=8, decode_scan=1, kv_pages=128)
CONTROL_B = dict(slots=16, decode_scan=4, kv_pages=256)
CONTROL_C = dict(CONTROL_B, kv_dtype="int8")
# the switch a concurrent POST meets (its 409): the phase-split loop, so
# the flash pair's captured prefills join the path
CONTROL_D = dict(CONTROL_C, slots=8, mixed_batch="off")
# an int8 pool of 16384 x 128-token pages: ~137 GB, more than the card
CONTROL_OOM_PAGES = 65536        # 16 GiB of int8 pages a layer: past the card
# (2)'s mid-stream switches, in order (the start: 8 slots, decode_scan 1,
# 128 x 128-token pages, mixed batching on)
CONTROL_ID_START = dict(slots=8, decode_scan=1, kv_pages=128,
                        kv_page_size=128)
CONTROL_ID_SWITCHES = (
    dict(CONTROL_ID_START, slots=4),
    dict(CONTROL_ID_START, slots=8),
    dict(CONTROL_ID_START, decode_scan=4),
    dict(CONTROL_ID_START, decode_scan=4, kv_pages=64),
    dict(CONTROL_ID_START, decode_scan=4, kv_pages=128, kv_page_size=64),
    dict(CONTROL_ID_START, decode_scan=4, kv_pages=128, kv_page_size=64,
         mixed_batch="off"),
    dict(CONTROL_ID_START, decode_scan=4, kv_pages=128, kv_page_size=64,
         mixed_batch="auto"),
)
CONTROL_ID_NEW = 36
# (3): the auto engine's regimes (offered requests a second), its
# controller, and the drive
CONTROL_RPS = 4.0
CONTROL_LOW = 4                   # one chat a second
CONTROL_BURST = 24
# the rollback verdict's samples in (3): 40 x 0.5 s, past the drive
CONTROL_VERDICT = 40
# (4): the sched phase's 48-chat shed burst, this many times
CONTROL_SHED_BURSTS = 4
# (1)'s profile wave: tokens a chat (a wave that outlasts the capture's
# start)
CONTROL_PROFILE_NEW = 96
# seconds after which the phase dumps every thread's stack and exits
CONTROL_HANG_S = 360
CONTROL_ROUTE_KEYS = ("steps", "events", "traces", "anomalies", "actions",
                      "stats", "metrics", "journal_tail")


def _http_json(url: str, body=None, timeout: float = 600):
    """(status, JSON body) of a GET, or of a POST when `body` is given."""
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _watch_switches(torch, eng) -> list:
    """Wrap the engine's switch body (it runs on the engine thread, the
    only thread on the card): for each switch, the bytes allocated and
    reserved before it, the peak allocated during it, both after, the old
    and the new pool's bytes, its seconds, and its outcome."""
    seen = []
    real = eng._reconfigure_sync

    def switch(new, reason):
        torch.cuda.synchronize()
        rec = dict(to=new.to_dict(), before=torch.cuda.memory_allocated(),
                   reserved_before=torch.cuda.memory_reserved(),
                   old_pool=eng.cache.memory_bytes())
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            rec["switched"] = real(new, reason)
            return rec["switched"]
        except Exception as e:    # noqa: BLE001 — recorded, then raised
            rec["error"] = f"{type(e).__name__}: {e}"[:400]
            raise
        finally:
            torch.cuda.synchronize()
            rec.update(seconds=time.perf_counter() - t0,
                       peak=torch.cuda.max_memory_allocated(),
                       after=torch.cuda.memory_allocated(),
                       reserved_after=torch.cuda.memory_reserved(),
                       new_pool=eng.cache.memory_bytes())
            seen.append(rec)

    eng._reconfigure_sync = switch
    return seen


def _count_captures(eng) -> list:
    """Every graph capture of the engine, as its JAX function's name."""
    seen = []
    real = eng.flight.count_capture

    def count(fn, s):
        seen.append(fn)
        real(fn, s)
    eng.flight.count_capture = count
    return seen


def _launch_snapshot(rpa, fa) -> dict:
    return {**rpa.LAUNCHES, **fa.LAUNCHES}


def _control_wave(srv, tag: str, during=None, n_new: int = CONTROL_NEW):
    """The six TIER_CHATS at once through `srv`; `during()` runs once
    every chat has its first token. Returns (the wave's record, its
    requests, what during() returned); every chat must get 200."""
    names = [f"{tag}{i}" for i in range(len(TIER_CHATS))]
    st = srv.engine.stats
    tok0, dec0 = st.tokens_generated, st.decode_time_s
    t0 = time.perf_counter()
    for name, n in zip(names, TIER_CHATS):
        srv.post(name, "standard", n, n_new)
    got = None
    if during is not None:
        srv.wait_tokens(names, 1)
        got = during()
    srv.join()
    wall = time.perf_counter() - t0
    reqs = []
    for name in names:
        code, err = srv.status.get(name, (None, None))
        if code != 200:
            fail(f"control {tag}: {name!r} got {code} {err}")
        reqs.append(srv.request(name))
    ttfts = [r.first_token_t - r.submit_t for r in reqs]
    rec = dict(ttft_p50_s=statistics.median(ttfts), ttft_max_s=max(ttfts),
               decode_tok_s=(st.tokens_generated - tok0)
               / max(st.decode_time_s - dec0, 1e-9),
               wall_s=wall, tokens=[len(r.out_tokens) for r in reqs])
    return rec, reqs, got


def _control_profile(srv) -> dict:
    """Inside a wave of CONTROL_PROFILE_NEW-token chats, once every chat
    has its first token: POST /api/v1/profile {"seconds": 1} on a
    thread and a second POST while it runs (409); then the trace's
    kernel rows: the port's kernels must be among them, and every chat
    200. The server was built with --profile-dir, which warmed the
    profiler at startup, so the capture starts at once."""
    url = srv.url
    box = {}

    def capture():
        box["got"] = _http_json(url + "/api/v1/profile", {"seconds": 1},
                                timeout=120)

    def during():
        t = threading.Thread(target=capture)
        t.start()
        time.sleep(0.3)
        got = _http_json(url + "/api/v1/profile", {"seconds": 1},
                         timeout=120)
        t.join(timeout=150)
        if t.is_alive():
            import faulthandler
            faulthandler.dump_traceback(all_threads=True)
            fail("control profile: the capture did not return in 150 s")
        return got

    _, _, (code2, err2) = _control_wave(srv, "P", during,
                                        n_new=CONTROL_PROFILE_NEW)
    code, out = box.get("got", (None, {}))
    log(f"control profile: the capture {code} {out}, the concurrent one "
        f"{code2} {err2}")
    if code != 200 or code2 != 409:
        fail(f"control profile: the capture got {code} {out}, the "
             f"concurrent one {code2} {err2}")
    with open(out["trace"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = Counter()
    for e in events:
        if e.get("cat") == "kernel":
            name = e.get("name", "")
            m = _PORT_KERNEL.search(name)
            kernels[re.search(r"::(\w+)", name[m.start():]).group(1)
                    if m else "other"] += 1
    ours = {k: n for k, n in kernels.items() if k != "other"}
    if not ours:
        fail(f"control profile: no kernel of the port in the trace "
             f"({sum(kernels.values())} kernel rows; events by category "
             f"{dict(Counter(e.get('cat') for e in events))})")
    return dict(trace=out["trace"], seconds=out["seconds"],
                kernel_rows=sum(kernels.values()), port_kernels=ours,
                concurrent=code2)


def _control_served(torch, rpa, fa, cfg, params, card: str, tmp: str):
    """(1) The bf16 weights (cut to CUT_LAYERS) behind the HTTP API with
    --autotune
    manual, the sentinel and its action plane, --profile-dir and
    --postmortem-dir: a cold and a warm wave at CONTROL_A, switch 1 to
    CONTROL_B inside a wave (every chat holding its first token), a warm
    wave, switch 2 to CONTROL_C (int8 pages) inside a wave, a warm wave;
    inside the next wave the int8 -> bf16 refusal, a pool the in-flight
    streams do not fit, and a switch to CONTROL_D met by a concurrent
    POST (409); a warm wave at CONTROL_D; a profile capture (and its
    concurrent 409) inside a wave; then a pool the card cannot hold
    (400, CONTROL_D kept).
    Returns (launches of the measured waves, record, the step logs of
    CONTROL_A's and CONTROL_B's drives)."""
    pm_dir = os.path.join(tmp, "postmortem")
    step_log = os.path.join(tmp, "steps.jsonl")
    srv = _SchedServer(
        torch, cfg, params, torch.bfloat16, False,
        kv_pages=CONTROL_A["kv_pages"], decode_scan=CONTROL_A["decode_scan"],
        autotune="manual", sentinel=True, sentinel_interval=0.5,
        sentinel_act=True, profile_dir=os.path.join(tmp, "profile"),
        postmortem_dir=pm_dir, step_log=step_log)
    eng = srv.engine
    switches = _watch_switches(torch, eng)
    captures = _count_captures(eng)
    rec = {"waves": {}, "switches": [], "refusals": {}}
    waves = rec["waves"]

    def wave(tag, during=None):
        c0 = len(captures)
        l0 = _launch_snapshot(rpa, fa)
        got, reqs, out = _control_wave(srv, tag, during)
        got["captures"] = len(captures) - c0
        got["config"] = eng.current_config().to_dict()
        got["launches"] = {k: n - l0[k]
                           for k, n in _launch_snapshot(rpa, fa).items()
                           if n - l0[k]}
        waves[tag] = got
        log(f"control wave {tag} at {got['config']}: TTFT p50 "
            f"{got['ttft_p50_s']:.3f} s, decode {got['decode_tok_s']:.1f} "
            f"tok/s, wall {got['wall_s']:.2f} s, {got['captures']} "
            f"captures, launches {got['launches']} [{card}]")
        return reqs, out

    def switch(cfg_):
        code, out = _http_json(srv.url + "/api/v1/autotune",
                               {"config": cfg_})
        if code != 200 or not out.get("switched"):
            fail(f"control: the switch to {cfg_} got {code} {out}")
        return out

    wave("A0")                       # cold: captures A's variants
    rpa.reset_launch_counts()
    fa.reset_launch_counts()
    wave("A1")
    t_a = time.time()
    reqs1, _ = wave("AB", lambda: switch(CONTROL_B))
    t_b = time.time()
    wave("B1")
    wave("BC", lambda: switch(CONTROL_C))
    t_c = time.time()
    wave("C1")

    def refusals():
        out = {}
        out["guard"] = _http_json(srv.url + "/api/v1/autotune",
                                  {"config": CONTROL_B})
        out["fit"] = _http_json(srv.url + "/api/v1/autotune",
                                {"config": dict(CONTROL_C, kv_pages=2)})
        box = {}
        a = threading.Thread(target=lambda: box.update(
            d=_http_json(srv.url + "/api/v1/autotune",
                         {"config": CONTROL_D})))
        a.start()
        deadline = time.monotonic() + 30
        while not eng._switch_inflight and time.monotonic() < deadline:
            time.sleep(0.0005)
        out["concurrent"] = _http_json(srv.url + "/api/v1/autotune",
                                       {"config": CONTROL_C})
        a.join(timeout=600)
        out["switch_d"] = box.get("d")
        return out

    _, ref = wave("CD", refusals)
    wave("D1")
    counts = _launch_snapshot(rpa, fa)
    rec["profile"] = _control_profile(srv)
    _, oom = wave("DX", lambda: _http_json(
        srv.url + "/api/v1/autotune",
        {"config": dict(CONTROL_D, kv_pages=CONTROL_OOM_PAGES)}))
    for name, (code, body), want, text in (
            ("guard", ref["guard"], 400, "int8-pool -> float-pool"),
            ("fit", ref["fit"], 400, "no stream may be dropped"),
            ("concurrent", ref["concurrent"], 409, "in flight"),
            ("oom", oom, 400, "OutOfMemoryError")):
        rec["refusals"][name] = dict(code=code, error=body.get("error"))
        log(f"control refusal ({name}): {code} {body.get('error', '')[:160]}")
        if code != want or text not in body.get("error", ""):
            fail(f"control: the {name} switch got {code} {body}, "
                 f"expected {want} naming {text!r}")
    d_code, d_out = ref["switch_d"] or (None, {})
    if d_code != 200 or not d_out.get("switched"):
        fail(f"control: the switch to CONTROL_D got {d_code} {d_out}")
    got_cfg = eng.current_config().to_dict()
    want_cfg = dict(eng.current_config().to_dict(), **CONTROL_D)
    if got_cfg != want_cfg:
        fail(f"control: after the OOM switch the engine is at {got_cfg}, "
             f"not the previous config {CONTROL_D}")
    prof = rec["profile"]
    log(f"control profile: {prof['kernel_rows']} kernel rows in "
        f"{prof['seconds']} s of capture, the port's: "
        f"{prof['port_kernels']}; the concurrent capture "
        f"{prof['concurrent']} [{card}]")

    # each switch: seconds, streams carried, memory against the pools
    code, st = _http_json(srv.url + "/api/v1/autotune")
    log_by_epoch = {e["epoch"]: e for e in st["switch_log"]}
    landed = [s for s in switches if s.get("switched")]
    for i, s in enumerate(landed):
        entry = log_by_epoch.get(i + 1, {})
        pool = max(s["old_pool"], s["new_pool"])
        r = dict(to=s["to"], seconds=s["seconds"],
                 carried=entry.get("carried"), before=s["before"],
                 peak=s["peak"], after=s["after"],
                 reserved_before=s["reserved_before"],
                 reserved_after=s["reserved_after"], old_pool=s["old_pool"],
                 new_pool=s["new_pool"])
        rec["switches"].append(r)
        log(f"control switch {i + 1} -> {s['to']}: {s['seconds']:.3f} s, "
            f"{r['carried']} streams carried; allocated "
            f"{s['before'] / 2**30:.3f} GiB before, peak "
            f"{s['peak'] / 2**30:.3f}, {s['after'] / 2**30:.3f} after "
            f"(pools {s['old_pool'] / 2**30:.3f} -> "
            f"{s['new_pool'] / 2**30:.3f} GiB); reserved "
            f"{s['reserved_before'] / 2**30:.3f} -> "
            f"{s['reserved_after'] / 2**30:.3f} GiB [{card}]")
        if s["peak"] > max(s["before"], s["after"]) + 0.1 * pool:
            fail(f"control: switch {i + 1} peaked "
                 f"{(s['peak'] - max(s['before'], s['after'])) / 2**30:.3f}"
                 " GiB above what it held: the old pool was still live")
    if len(landed) != 3:
        fail(f"control: {len(landed)} switches landed, expected 3")
    failed = [s for s in switches if "error" in s]
    rec["oom_switch"] = [dict(error=s["error"], before=s["before"],
                              after=s["after"],
                              reserved_after=s["reserved_after"])
                         for s in failed if "OutOfMemory" in s["error"]]
    for tag in ("A1", "B1", "C1", "D1"):
        if waves[tag]["captures"]:
            fail(f"control: the warm wave {tag} after a switch captured "
                 f"{waves[tag]['captures']} graphs")
    for tag, keys in (("C1", ("rpa_decode_q8", "rpa_mixed_q8")),
                      ("D1", ("rpa_decode_q8", "flash_attn_cached")),
                      ("A1", ("rpa_decode", "rpa_mixed")),
                      ("B1", ("rpa_decode", "rpa_mixed"))):
        for k in keys:
            if not waves[tag]["launches"].get(k):
                fail(f"control: {k} never launched in the wave {tag}")
    plain = {k: n for k, n in counts.items() if k.endswith("_plain") and n}
    if plain:
        fail(f"control: plain versions ran: {plain}")

    # a folded chat explains itself; an unknown rid is a 404
    rid = reqs1[0].rid
    code, tl = _http_json(f"{srv.url}/api/v1/requests/{rid}/timeline")
    folds = [e for e in tl.get("timeline", ())
             if e["event"] == "reconfigured" and e["source"] == "trace"]
    steps = [e for e in tl.get("timeline", ()) if e["source"] == "steps"]
    code404, _ = _http_json(f"{srv.url}/api/v1/requests/999999/timeline")
    rec["timeline"] = dict(rid=rid, entries=len(tl.get("timeline", ())),
                           reconfigured=len(folds), steps=len(steps),
                           causes=tl.get("summary", {}).get("causes"),
                           unknown=code404)
    log(f"control timeline of rid {rid}: {rec['timeline']}")
    if code != 200 or not folds or not steps or code404 != 404:
        fail(f"control: the timeline route: {code} {rec['timeline']}")
    # what the sentinel saw and what the action plane did
    code, an = _http_json(srv.url + "/api/v1/anomalies")
    rec["anomalies"] = dict(
        fired=[(a["kind"], a["active"]) for a in an.get("anomalies", ())],
        actions=[(a["kind"], a["action"], a["outcome"])
                 for a in an.get("actions", ())])
    log(f"control anomalies: {rec['anomalies']['fired']}; actions "
        f"{rec['anomalies']['actions']} [{card}]")
    srv.close()
    del srv, eng
    torch.cuda.empty_cache()
    # the step logs of the A and B drives, for the fitter in (3)
    logs = {}
    with open(step_log) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    for name, lo, hi in (("A", t_a - 3600, t_a), ("B", t_b, t_c)):
        path = os.path.join(tmp, f"steps_{name}.jsonl")
        with open(path, "w") as f:
            for r in recs:
                if lo <= r["ts"] < hi:
                    f.write(json.dumps(r) + "\n")
        logs[name] = path
    return counts, rec, logs


def _control_f32_engine(torch, cfg, params, device, **kw):
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    return InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), device=device,
        max_slots=CONTROL_ID_START["slots"], max_seq_len=1024,
        kv_pages=CONTROL_ID_START["kv_pages"],
        kv_page_size=CONTROL_ID_START["kv_page_size"], prefill_chunk=64,
        decode_scan_steps=CONTROL_ID_START["decode_scan"],
        cache_dtype=torch.float32, sampling=SamplingConfig(temperature=0.0),
        recovery=True, **kw)


def _control_identity(torch, card: str) -> dict:
    """(2) 8B width, 2 layers, f32 weights and pool: greedy streams that
    cross CONTROL_ID_SWITCHES mid-stream equal the uninterrupted card
    run's and the CPU engine's, the pool is conserved, a warm drive at
    the last config captures nothing, and an in-place recovery there
    captures nothing anew."""
    from cake_tpu_torch.faults import build_injector
    from cake_tpu_torch.models.llama.config import LlamaConfig

    cfg32, p32 = _f32_params(torch, LlamaConfig.llama3_8b())
    cpu = {k: v.cpu() for k, v in p32.items() if k != "blocks"}
    cpu["blocks"] = {k: v.cpu() for k, v in p32["blocks"].items()}
    prompts = _f32_prompts()
    box = {}

    def cpu_run():
        eng = _control_f32_engine(torch, cfg32, cpu, "cpu")
        hs = [eng.submit(p, max_new_tokens=CONTROL_ID_NEW)
              for p in prompts]
        with eng:
            box["cpu"] = [list(h._req.out_tokens) if h.wait(900) else None
                          for h in hs]

    t_cpu = threading.Thread(target=cpu_run)
    t_cpu.start()

    def drive(eng, switches=()):
        hs = [eng.submit(p, max_new_tokens=CONTROL_ID_NEW) for p in prompts]
        for i, c in enumerate(switches):
            deadline = time.monotonic() + 300
            while (len(hs[0]._req.out_tokens) < 4 * (i + 1)
                   and time.monotonic() < deadline):
                time.sleep(0.0005)
            if hs[0]._req.done.is_set():
                fail(f"control identity: the stream finished before "
                     f"switch {i + 1}")
            if not eng.reconfigure(c):
                fail(f"control identity: switch {i + 1} to {c} was a no-op")
        for h in hs:
            if not h.wait(600) or h._req.error is not None:
                fail(f"control identity: a stream failed ({h._req.error})")
        pg = eng._pager
        if pg.live_pages or pg.free_pages != pg.n_pages:
            fail(f"control identity: pool not conserved: free "
                 f"{pg.free_pages}, live {pg.live_pages}, {pg.n_pages}")
        return [list(h._req.out_tokens) for h in hs]

    plain = _control_f32_engine(torch, cfg32, p32, DEV)
    with plain:
        ref = drive(plain)
    del plain
    eng = _control_f32_engine(torch, cfg32, p32, DEV)
    captures = _count_captures(eng)
    rec = {}
    with eng:
        got = drive(eng, CONTROL_ID_SWITCHES)
        c0 = len(captures)
        warm = drive(eng)
        c1 = len(captures)
        eng._faults = build_injector("seed=3;engine.mixed:nth=2:transient")
        faulted = drive(eng)
        c2 = len(captures)
    t_cpu.join(timeout=900)
    rec = dict(switched=got == ref, cpu=box.get("cpu") == ref,
               warm=warm == ref, faulted=faulted == ref,
               switches=eng.stats.config_switches, epoch=eng.config_epoch,
               captures_switched=c0, captures_warm=c1 - c0,
               captures_recovery=c2 - c1, recoveries=eng.stats.recoveries,
               config=eng.current_config().to_dict())
    log(f"control identity (f32, 2 layers, {len(CONTROL_ID_SWITCHES)} "
        f"mid-stream switches): streams == uninterrupted {rec['switched']},"
        f" == CPU engine {rec['cpu']}; warm drive == {rec['warm']} with "
        f"{rec['captures_warm']} captures; {rec['recoveries']} in-place "
        f"recovery, {rec['captures_recovery']} captures anew, streams == "
        f"{rec['faulted']} [{card}]")
    if not (rec["switched"] and rec["cpu"] and rec["warm"]
            and rec["faulted"]):
        fail(f"control identity: {rec}")
    if (rec["switches"] != len(CONTROL_ID_SWITCHES) or rec["captures_warm"]
            or rec["captures_recovery"] or rec["recoveries"] != 1):
        fail(f"control identity: {rec}")
    del eng
    torch.cuda.empty_cache()
    return rec


def _control_auto(torch, cfg, params, logs: dict, card: str,
                  tmp: str) -> dict:
    """(3) The port's fitter over (1)'s step logs of CONTROL_A and
    CONTROL_B writes a policy that validates; then an --autotune auto
    engine at full width over a two-regime policy (CONTROL_A up to
    CONTROL_RPS offered requests a second, CONTROL_B past it) and a fast
    controller (interval 0.5 s, window 2, hold 1, cooldown 2 s): a
    low-rate wave, one chat a second, then a burst that crosses the
    boundary. The rollback verdict waits CONTROL_VERDICT samples, past
    the drive's end (as the JAX package's closed-loop drive keeps it out
    of reach), so nothing moves after the one switch and the drive sees
    exactly one policy switch; every chat 200."""
    from cake_tpu_torch.autotune import ControllerConfig, PolicyTable

    fitted = os.path.join(tmp, "fitted.json")
    tree = os.path.dirname(os.path.dirname(
        importlib.util.find_spec("cake_tpu_torch").origin))
    cmd = [sys.executable, "-m", "cake_tpu_torch.tools.autotune_fit",
           "--step-log", logs["A"], "--step-config", json.dumps(CONTROL_A),
           "--step-log", logs["B"], "--step-config", json.dumps(CONTROL_B),
           "--window", "1.0", "--out", fitted]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=tree))
    log("control fitter: " + p.stdout.strip().replace("\n", "\n  "))
    if p.returncode != 0:
        fail(f"control: the fitter exited {p.returncode}: {p.stderr[-2000:]}")
    fit = PolicyTable.load(fitted).to_dict()
    policy = {"version": 1, "regimes": [
        {"max_offered_rps": CONTROL_RPS, "config": CONTROL_A},
        {"max_offered_rps": None, "config": CONTROL_B}]}
    path = os.path.join(tmp, "policy.json")
    with open(path, "w") as f:
        json.dump(policy, f)
    srv = _SchedServer(
        torch, cfg, params, torch.bfloat16, False,
        kv_pages=CONTROL_A["kv_pages"], decode_scan=CONTROL_A["decode_scan"],
        autotune="auto", autotune_policy=path, engine_kw=dict(
            autotune_config=ControllerConfig(
                interval_s=0.5, window=2, hold=1, cooldown_s=2.0,
                rollback_window=CONTROL_VERDICT)))
    eng = srv.engine
    t0 = time.perf_counter()
    low = [f"L{i}" for i in range(CONTROL_LOW)]
    for i, name in enumerate(low):
        srv.post(name, "standard", TIER_CHATS[i % len(TIER_CHATS)], 32)
        time.sleep(1.0)
    srv.join()
    switched_low = eng.stats.config_switches
    burst = [f"U{i}" for i in range(CONTROL_BURST)]
    for i, name in enumerate(burst):
        srv.post(name, "standard", TIER_CHATS[i % len(TIER_CHATS)], 32)
    srv.join()
    codes = [srv.status.get(n, (None,))[0] for n in low + burst]
    st = eng.autotune_state()
    srv.close()
    rec = dict(fitted=fit, policy=policy,
               switches=[(e["reason"], e["to"]) for e in st["switch_log"]],
               switched_in_low_wave=switched_low,
               decisions=st["controller"]["decisions"],
               wall_s=time.perf_counter() - t0,
               codes=sorted(set(codes)))
    for d in rec["decisions"]:
        log(f"control auto decision: {d}")
    log(f"control auto: {len(rec['switches'])} switches "
        f"{rec['switches']}, codes {rec['codes']} [{card}]")
    if (codes != [200] * len(codes) or switched_low
            or [r for r, _ in rec["switches"]] != ["auto"]):
        fail(f"control auto: {rec['switches']}, codes {rec['codes']}, "
             f"{switched_low} switches in the low-rate wave")
    del srv, eng
    torch.cuda.empty_cache()
    return rec


def _control_shed(torch, cfg, params, card: str) -> dict:
    """(4a) The sched phase's shed burst with --sentinel
    --sentinel-interval 0.5: CONTROL_SHED_BURSTS bursts of 48 batch
    chats half a second apart (the detector fires on two consecutive
    windows over its threshold, and one burst's sheds land within one
    window); shed_storm fires, then clears, read from /api/v1/anomalies
    and cake_anomaly_total; every chat 200 or 429."""
    from cake_tpu_torch.sched import SchedConfig
    from cake_tpu_torch.sched.classes import DEFAULT_POLICIES, ClassPolicy

    pol = tuple(ClassPolicy(p.name, p.rank, p.aging_s,
                            1.0 if p.name == "batch" else p.target_wait_s)
                for p in DEFAULT_POLICIES)
    srv = _SchedServer(torch, cfg, params, torch.bfloat16, True, shed=True,
                       sched_config=SchedConfig(policies=pol),
                       sentinel=True, sentinel_interval=0.5)
    for i in range(4):
        srv.post(f"W{i}", "batch", 160, 4)
        srv.join()
    time.sleep(1.0)
    burst = [f"S{i}" for i in range(48 * CONTROL_SHED_BURSTS)]
    for g in range(CONTROL_SHED_BURSTS):
        for name in burst[48 * g:48 * (g + 1)]:
            srv.post(name, "batch", 160, 8)
        time.sleep(0.5)
    srv.join()
    fired = cleared = None
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        _, an = _http_json(srv.url + "/api/v1/anomalies")
        recs = [a for a in an["anomalies"] if a["kind"] == "shed_storm"]
        fired = bool(recs)
        cleared = fired and not any(a["active"] for a in recs)
        if cleared:
            break
        time.sleep(0.25)
    text = _get(srv.url + "/metrics").decode()
    n_metric = _metric(text, "cake_anomaly_total", kind="shed_storm")
    codes = [srv.status[s][0] for s in burst]
    if set(codes) - {200, 429}:
        fail(f"control shed: codes {sorted(set(codes))}")
    rec = dict(shed=codes.count(429), admitted=codes.count(200),
               fired=fired, cleared=cleared, metric=n_metric,
               anomalies=[(a["kind"], a["active"])
                          for a in an["anomalies"]])
    srv.close()
    log(f"control shed: {rec['shed']} of {len(burst)} shed; shed_storm fired "
        f"{fired}, cleared {cleared}, cake_anomaly_total{{kind=shed_storm}} "
        f"{n_metric:.0f}; anomalies {rec['anomalies']} [{card}]")
    if not (fired and cleared and n_metric >= 1):
        fail(f"control shed: {rec}")
    del srv
    torch.cuda.empty_cache()
    return rec


def _control_breaker(torch, card: str, tmp: str) -> dict:
    """(4b) A storm-breaker stop of the f32 engine with --postmortem-dir,
    --journal, --sentinel and --sentinel-act writes exactly one bundle,
    with the keys of CONTROL_ROUTE_KEYS."""
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.serve.errors import RecoveryConfig

    cfg32, p32 = _f32_params(torch, LlamaConfig.llama3_8b())
    pm = os.path.join(tmp, "breaker")
    eng = _control_f32_engine(
        torch, cfg32, p32, DEV, postmortem_dir=pm,
        journal=os.path.join(tmp, "breaker.jsonl"), sentinel=True,
        sentinel_act=True,
        fault_plan="seed=5;engine.step:step=6:transient:times=50",
        recovery_config=RecoveryConfig(backoff_base_s=0.05,
                                       backoff_cap_s=0.1))
    hs = [eng.submit(p, max_new_tokens=16) for p in _f32_prompts()]
    with eng:
        for h in hs:
            h.wait(300)
        eng._thread.join(timeout=120)
    files = sorted(f for f in os.listdir(pm) if f.endswith(".json"))
    if len(files) != 1:
        fail(f"control breaker: {len(files)} bundles: {files}")
    with open(os.path.join(pm, files[0])) as f:
        bundle = json.load(f)
    missing = [k for k in CONTROL_ROUTE_KEYS if k not in bundle]
    rec = dict(bundle=files[0], trigger=bundle.get("trigger"),
               missing=missing, recoveries=eng.stats.recoveries,
               journal_tail=len(bundle.get("journal_tail") or ()))
    log(f"control breaker: stopped {eng.stopped} after "
        f"{eng.stats.recoveries} recoveries; one bundle {files[0]} "
        f"(trigger {rec['trigger']}), keys missing {missing} [{card}]")
    if (not eng._breaker_tripped or missing
            or rec["trigger"] != "breaker_stop"):
        fail(f"control breaker: {rec}")
    del eng, p32
    torch.cuda.empty_cache()
    return rec


def phase_control(torch, rpa, fa, cfg, params, card: str):
    """The control phase: (1) live switches at full width through the
    API, (2) the f32 identity across switches, (3) auto mode, (4) the
    sentinel's shed storm and the breaker's postmortem bundle. Returns
    (the launch counts of (1)'s measured waves, record)."""
    import tempfile

    import faulthandler

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="cake-control-")
    # a hang (a step that never returns) must not eat the run's time:
    # dump every thread's stack and exit
    faulthandler.dump_traceback_later(CONTROL_HANG_S, exit=True)
    # (1) and (3) at the first CUT_LAYERS blocks; (4)'s shed storm
    # needs the full depth's service rate to shed enough
    cut_cfg, cut_params = _cut_draft(cfg, params, CUT_LAYERS)
    counts, served, logs = _control_served(torch, rpa, fa, cut_cfg,
                                           cut_params, card, tmp)
    rec = dict(served=served)
    parts = {"served": time.perf_counter() - t0}
    for name, fn in (
            ("identity", lambda: _control_identity(torch, card)),
            ("auto", lambda: _control_auto(torch, cut_cfg, cut_params, logs,
                                           card, tmp)),
            ("shed", lambda: _control_shed(torch, cfg, params, card)),
            ("breaker", lambda: _control_breaker(torch, card, tmp))):
        t1 = time.perf_counter()
        rec[name] = fn()
        parts[name] = time.perf_counter() - t1
    faulthandler.cancel_dump_traceback_later()
    rec["seconds"] = time.perf_counter() - t0
    rec["part_seconds"] = parts
    log(f"control phase: {rec['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()) + ")")
    return counts, rec


# -- phase: disagg --------------------------------------------------------------

DISAGG_TOKEN = "chip-smoke-disagg"
DISAGG_HEAD = 32                  # (a): the shared head (two 16-token pages)
DISAGG_TAILS = (8, 68, 38, 98, 23, 58)   # (a): each chat's own tokens
DISAGG_NEW_ID = 16                # (a): tokens a chat
DISAGG_NEW = 64                   # (b): tokens a chat
DISAGG_PROMPT = 1000              # (b): tokens a chat's prompt: 8 pages
# (b): a shipment's bytes, reckoned by hand: 8 pages x CUT_LAYERS x
# 128 tokens x 8 kv heads x 128 x 2 bytes x (k, v); over int8 one byte
# an element plus the f32 scales, 8 pages x layers x 8 heads x 4 B x 2
DISAGG_BYTES = {"bf16": 8 * CUT_LAYERS * 128 * 8 * 128 * 2 * 2,
                "int8": 8 * CUT_LAYERS * 128 * 8 * 128 * 2
                + 8 * CUT_LAYERS * 8 * 4 * 2}
DISAGG_OUTCOMES = ("adopted", "degraded", "fault", "epoch", "timeout",
                   "checksum", "geometry")


def _release(torch, gone=()) -> None:
    """Hand what dropped engines held back to the card. `gone` holds
    weak references to the engines just dropped: a stopped engine is in
    no reference cycle (its planes and its runners' capture hooks hold
    it weakly), so its refcount alone frees its pool and graphs, and one
    still alive here fails the phase. The collection after it is only a
    safety net for what else became garbage."""
    import gc
    alive = [i for i, r in enumerate(gone) if r() is not None]
    if alive:
        fail(f"stopped engine(s) {alive} of {len(gone)} outlived their "
             "last reference (a reference cycle)")
    gc.collect()
    torch.cuda.empty_cache()


def _adopt_counts() -> dict:
    from cake_tpu_torch.kv import transfer
    return {o: transfer._ADOPT_TOTAL.labels(outcome=o).value
            for o in DISAGG_OUTCOMES}


def _disagg_pair(build):
    """A started prefill + decode pair over loopback, the decode plane
    connected (until then request_prefill declines and every chat would
    prefill locally). build(**kw) makes one engine."""
    pre = build(disagg="prefill", disagg_peer="127.0.0.1:0",
                disagg_token=DISAGG_TOKEN).start()
    dec = build(disagg="decode", disagg_peer=f"127.0.0.1:{pre._disagg.port}",
                disagg_token=DISAGG_TOKEN, disagg_timeout_s=120.0).start()
    if not dec._disagg.wait_connected(60):
        fail("disagg: the transfer channel never connected")
    return pre, dec


def _disagg_free(engines, label: str, floors=None) -> None:
    """Every engine's allocator back to its pages less `floors` (a
    registered prefix's pages), polled under a deadline."""
    deadline = time.monotonic() + 30.0
    floors = floors or [0] * len(engines)

    def back():
        return all(e._pager.free_pages == e._pager.n_pages - f
                   for e, f in zip(engines, floors))
    while not back() and time.monotonic() < deadline:
        time.sleep(0.005)
    if not back():
        fail(f"disagg {label}: pages not conserved "
             f"({[(e._pager.free_pages, e._pager.n_pages) for e in engines]})")


def _disagg_identity(torch, card: str) -> dict:
    """(a) 8B width, 2 layers, f32 weights and pool, 16-token pages: six
    greedy chats sharing a 32-token head through the pair, against one
    colocated card engine and the CPU engine (both with the head
    registered, and the card's also without), in these waves: plain; the
    head registered on both hosts; a kv.ship fault on the prefill host;
    a kv.adopt fault on the decode host; a reconfigure of the decode
    host while the shipments are held (outcome epoch); no prefill peer
    (the prefill host stopped: request_prefill declines). Identical
    streams and conserved pools after every wave; each outcome counted
    in cake_kv_adopt_total."""
    from cake_tpu_torch.faults import build_injector
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    t0 = time.perf_counter()
    cfg32, p32 = _f32_params(torch, LlamaConfig.llama3_8b())
    head = [(5 * j) % 250 + 1 for j in range(DISAGG_HEAD)]
    prompts = [head + [(7 * i + 3 * j) % 250 + 1 for j in range(n)]
               for i, n in enumerate(DISAGG_TAILS)]

    def build(device=DEV, params=p32, **kw):
        return InferenceEngine(
            cfg32, params, ByteTokenizer(cfg32.vocab_size), device=device,
            max_slots=8, max_seq_len=512, kv_pages=256, kv_page_size=16,
            prefill_chunk=64, cache_dtype=torch.float32,
            sampling=SamplingConfig(temperature=0.0), **kw)

    def wave(eng, label):
        hs = [eng.submit(p, max_new_tokens=DISAGG_NEW_ID) for p in prompts]
        for h in hs:
            if not h.wait(timeout=300) or h._req.error is not None:
                fail(f"disagg (a) {label}: a chat failed "
                     f"({h._req.error!r})")
        return [list(h._req.out_tokens) for h in hs]

    refs = {}
    for label, device, prefix in (("card", DEV, False),
                                  ("card+prefix", DEV, True),
                                  ("cpu+prefix", "cpu", True)):
        params = p32 if device == DEV else {
            k: ({n: t.cpu() for n, t in v.items()} if k == "blocks"
                else v.cpu()) for k, v in p32.items()}
        eng = build(device=device, params=params)
        with eng:
            if prefix:
                eng.register_prefix(head)
            refs[label] = wave(eng, label)
        gone = [weakref.ref(eng)]
        del eng, params
        _release(torch, gone)
    if len({json.dumps(v) for v in refs.values()}) != 1:
        fail(f"disagg (a): the colocated references differ: {refs}")
    want = refs["card"]
    pre, dec = _disagg_pair(build)
    waves = {}
    expect = {"plain": ("adopted", 6), "prefix": ("adopted", 6),
              "ship_fault": ("degraded", 1), "adopt_fault": ("fault", 1),
              "epoch": ("epoch", 6), "no_peer": (None, 0)}
    try:
        for label in expect:
            a0 = _adopt_counts()
            k0 = dec.stats.kv_adopts
            pids = []
            if label == "prefix":
                pids = [pre.register_prefix(head), dec.register_prefix(head)]
            elif label == "ship_fault":
                pre._faults = build_injector(
                    "seed=5;kv.ship:nth=1:transient")
            elif label == "adopt_fault":
                pre._faults = None
                dec._faults = build_injector(
                    "seed=5;kv.adopt:nth=1:transient")
            elif label == "epoch":
                dec._faults = None
            elif label == "no_peer":
                pre.stop()
                deadline = time.monotonic() + 30.0
                while (dec._disagg._connected.is_set()
                       and time.monotonic() < deadline):
                    time.sleep(0.005)
                if dec._disagg._connected.is_set():
                    fail("disagg (a): the decode plane kept its channel")
            if label == "epoch":
                # the prefill host's writer holds its first send until
                # the decode host has switched: every shipment is
                # captured (queued) and none has left
                plane = pre._disagg
                gate, real = threading.Event(), plane._send_item

                def held_send(stream, item, _real=real):
                    gate.wait(120)
                    _real(stream, item)
                plane._send_item = held_send
                ships0 = pre.stats.kv_ships
                hs = [dec.submit(p, max_new_tokens=DISAGG_NEW_ID)
                      for p in prompts]
                deadline = time.monotonic() + 120.0
                while pre.stats.kv_ships < ships0 + len(prompts) and \
                        time.monotonic() < deadline:
                    time.sleep(0.005)
                cur = dec.current_config().to_dict()
                dec.reconfigure(dict(cur, decode_scan=4))
                plane._send_item = real
                gate.set()
                for h in hs:
                    if not h.wait(timeout=300) or h._req.error is not None:
                        fail("disagg (a) epoch: a chat failed")
                got = [list(h._req.out_tokens) for h in hs]
            else:
                got = wave(dec, label)
            a1 = _adopt_counts()
            delta = {o: a1[o] - a0[o] for o in a1 if a1[o] != a0[o]}
            adopts = dec.stats.kv_adopts - k0
            waves[label] = dict(identical=got == want, adopts=adopts,
                                outcomes=delta)
            log(f"disagg (a) {label}: identical {got == want}, adopted "
                f"{adopts}, outcomes {delta}")
            if got != want:
                fail(f"disagg (a) {label}: streams differ from the "
                     "colocated engines'")
            o, n = expect[label]
            if o is not None and delta.get(o) != n:
                fail(f"disagg (a) {label}: expected {n} {o!r} outcomes, "
                     f"got {delta}")
            want_adopts = {"plain": 6, "prefix": 6, "ship_fault": 5,
                           "adopt_fault": 5}.get(label, 0)
            if adopts != want_adopts:
                fail(f"disagg (a) {label}: {adopts} adoptions, expected "
                     f"{want_adopts}")
            if pids:
                pre.unregister_prefix(pids[0])
                dec.unregister_prefix(pids[1])
            live = [dec] if label == "no_peer" else [pre, dec]
            _disagg_free(live, f"(a) {label}")
    finally:
        dec.stop()
        pre.stop()
    gone = [weakref.ref(pre), weakref.ref(dec)]
    del pre, dec, p32, live
    _release(torch, gone)
    return dict(waves=waves, seconds=time.perf_counter() - t0)


def _disagg_full(torch, rpa, cfg, params, card: str):
    """(b) the first CUT_LAYERS bf16 blocks, 128 x 128-token pages and 8
    slots on
    each host, the decode host behind the HTTP API: six chats of
    DISAGG_PROMPT-token prompts and DISAGG_NEW tokens, a warm-up wave
    then a measured one, on the colocated engine, the pair, and the pair
    over int8 pages. Returns (the pair waves' launches, records)."""
    from cake_tpu_torch.kv import transfer
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    records, launches = [], Counter()
    args_kw = dict(kv_pages=128, prefill_chunk=256, sample_len=DISAGG_NEW)
    for label, kv_dtype, paired in (("colocated", None, False),
                                    ("pair", None, True),
                                    ("pair int8", "int8", True)):
        pre = None
        engine_kw = {}
        if paired:
            pre = InferenceEngine(
                cfg, params, ByteTokenizer(cfg.vocab_size), device=DEV,
                max_slots=8, max_seq_len=2048, kv_pages=128,
                kv_page_size=128, prefill_chunk=256,
                cache_dtype=torch.bfloat16, kv_dtype=kv_dtype,
                sampling=SamplingConfig(temperature=0.0),
                disagg="prefill", disagg_peer="127.0.0.1:0",
                disagg_token=DISAGG_TOKEN).start()
            engine_kw = dict(disagg="decode", disagg_token=DISAGG_TOKEN,
                             disagg_peer=f"127.0.0.1:{pre._disagg.port}",
                             disagg_timeout_s=120.0)
        srv = _SchedServer(torch, cfg, params, torch.bfloat16, False,
                           engine_kw=engine_kw, kv_dtype=kv_dtype,
                           **args_kw)
        eng = srv.engine
        try:
            if paired and not eng._disagg.wait_connected(60):
                fail(f"disagg (b) {label}: the channel never connected")
            caps = _count_captures(eng)
            pre_caps = _count_captures(pre) if pre else []
            ship_s = []
            real_observe = transfer._SHIP_SECONDS.observe

            def observe(v, _real=real_observe):
                ship_s.append(v)
                _real(v)
            for run in ("warm-up", "measured"):
                if run == "measured":
                    rpa.reset_launch_counts()
                    del caps[:], pre_caps[:], ship_s[:]
                    transfer._SHIP_SECONDS.observe = observe
                tok0, dec0 = eng.stats.tokens_generated, \
                    eng.stats.decode_time_s
                k0 = eng.stats.kv_adopts
                s0 = dict(pre._disagg.stats) if pre else {}
                kinds0 = Counter(r["kind"] for r in eng.flight.dump())
                pkinds0 = (Counter(r["kind"] for r in pre.flight.dump())
                           if pre else Counter())
                n0 = len(eng.retired)
                p0 = len(pre.retired) if pre else 0
                t_wave = time.perf_counter()
                tags = [f"{run[0]}{label[:1]}{i}" for i in range(6)]
                for tag in tags:
                    srv.post(tag, "standard", DISAGG_PROMPT, DISAGG_NEW)
                srv.join()
                wall = time.perf_counter() - t_wave
                bad = {t: srv.status.get(t) for t in tags
                       if srv.status.get(t, (0,))[0] != 200}
                if bad:
                    fail(f"disagg (b) {label} [{run}]: chats failed {bad}")
                transfer._SHIP_SECONDS.observe = real_observe
                if run != "measured":
                    continue
                retired = list(eng.retired)[n0:]
                if len(retired) != 6 or any(
                        len(r.prompt_ids) != DISAGG_PROMPT
                        or len(r.out_tokens) != DISAGG_NEW
                        for r in retired):
                    fail(f"disagg (b) {label}: expected six chats of "
                         f"{DISAGG_PROMPT} + {DISAGG_NEW} tokens")
                dec_s = eng.stats.decode_time_s - dec0
                rec = dict(
                    label=label, wall_s=wall,
                    ttft_p50_s=statistics.median(
                        r.first_token_t - r.submit_t for r in retired),
                    decode_tok_s=((eng.stats.tokens_generated - tok0)
                                  / dec_s if dec_s else 0.0),
                    captures=len(caps) + len(pre_caps),
                    launches={k: n for k, n in rpa.LAUNCHES.items() if n},
                    step_kinds=dict(Counter(r["kind"]
                                            for r in eng.flight.dump())
                                    - kinds0))
                if paired:
                    st = pre._disagg.stats
                    n_ship = st["shipments"] - s0["shipments"]
                    per = (st["bytes"] - s0["bytes"]) / max(n_ship, 1)
                    p50 = statistics.median(ship_s) if ship_s else None
                    pre_ret = list(pre.retired)[p0:]
                    rec.update(
                        adopts=eng.stats.kv_adopts - k0,
                        shipments=n_ship, bytes_a_shipment=per,
                        ship_seconds_p50=p50,
                        ship_gb_s=(per / p50 / 1e9 if p50 else None),
                        prefill_host_ttft_p50_s=statistics.median(
                            r.first_token_t - r.submit_t for r in pre_ret),
                        prefill_host_step_kinds=dict(
                            Counter(r["kind"] for r in pre.flight.dump())
                            - pkinds0),
                        degraded=eng._disagg.stats["degraded"])
                    rec["channel_share"] = (
                        1.0 - rec["prefill_host_ttft_p50_s"]
                        / rec["ttft_p50_s"])
                    want = DISAGG_BYTES[kv_dtype or "bf16"]
                    if n_ship != 6 or per != want:
                        fail(f"disagg (b) {label}: {n_ship} shipments of "
                             f"{per} B, expected 6 of {want} B")
                    if rec["adopts"] != 6 or rec["degraded"]:
                        fail(f"disagg (b) {label}: {rec['adopts']} "
                             "adoptions of 6 chats, "
                             f"{rec['degraded']} degraded")
                    if set(rec["step_kinds"]) - {"decode", "decode_scan"}:
                        fail(f"disagg (b) {label}: the decode host ran "
                             f"{rec['step_kinds']}")
                    if {"decode", "decode_scan"} & set(
                            rec["prefill_host_step_kinds"]):
                        fail(f"disagg (b) {label}: the prefill host ran "
                             f"decode steps {rec['prefill_host_step_kinds']}")
                    for k, n in rpa.LAUNCHES.items():
                        launches[k] += n
                    suffix = _kernel_suffix(kv_dtype)
                    for k in ("rpa_decode" + suffix, "rpa_mixed" + suffix):
                        if rpa.LAUNCHES.get(k, 0) <= 0:
                            fail(f"disagg (b) {label}: {k} never launched")
                if rec["captures"]:
                    fail(f"disagg (b) {label}: the warm wave captured "
                         f"{rec['captures']} graph(s)")
                plain = {k: n for k, n in rpa.LAUNCHES.items()
                         if k.endswith("_plain") and n}
                if plain:
                    fail(f"disagg (b) {label}: plain folds ran {plain}")
                records.append(rec)
                log(f"disagg (b) {label}: TTFT p50 {rec['ttft_p50_s']:.3f} "
                    f"s, decode {rec['decode_tok_s']:.1f} tok/s, wall "
                    f"{wall:.2f} s"
                    + (f", {rec['shipments']} shipments of "
                       f"{rec['bytes_a_shipment']:.0f} B, ship p50 "
                       f"{rec['ship_seconds_p50']:.4f} s "
                       f"({rec['ship_gb_s']:.2f} GB/s), prefill-host TTFT "
                       f"p50 {rec['prefill_host_ttft_p50_s']:.3f} s, "
                       f"channel share {rec['channel_share']:.2f}"
                       if paired else "")
                    + f"; launches {rec['launches']}")
            if label == "pair":
                fleet = json.loads(_get(srv.url + "/api/v1/fleet"))
                if (fleet.get("local_host") != "coordinator"
                        or "note" not in fleet
                        or not fleet["hosts"]["coordinator"]["live"]):
                    fail(f"disagg (b): /api/v1/fleet answered {fleet}")
                records[-1]["fleet"] = fleet
                log(f"disagg (b) fleet: {json.dumps(fleet)}")
            _disagg_free([e for e in (pre, eng) if e is not None],
                         f"(b) {label}")
        finally:
            srv.close()
            if pre is not None:
                pre.stop()
        # the served engine waits for the collection: the HTTP
        # handler class the server makes is cyclic and holds it
        gone = [weakref.ref(pre)] if pre is not None else []
        del srv, eng, pre
        _release(torch, gone)
    return dict(launches), records


def phase_disagg(torch, rpa, cfg, params, card: str):
    """The disagg phase: (a) the identities at 2 layers, f32, (b) full
    width. Returns (the pair waves' launches, record)."""
    t0 = time.perf_counter()
    _release(torch)
    held = torch.cuda.memory_allocated()
    rec = dict(identity=_disagg_identity(torch, card))
    counts, rec["full"] = _disagg_full(torch, rpa, cfg, params, card)
    rec["seconds"] = time.perf_counter() - t0
    # the phase gives back what its engines took (the last ones became
    # garbage only as _disagg_full's frame went): the weight-quantized
    # phases after it need the card
    _release(torch)
    rec["held_gib"] = [held / 2**30, torch.cuda.memory_allocated() / 2**30]
    log(f"disagg: {rec['held_gib'][0]:.3f} GiB allocated before the "
        f"phase, {rec['held_gib'][1]:.3f} after")
    if torch.cuda.memory_allocated() > held + 2**30:
        fail(f"disagg: the phase kept {rec['held_gib']} GiB allocated")
    log(f"disagg phase: {rec['seconds']:.1f} s (identity "
        f"{rec['identity']['seconds']:.1f} s)")
    return counts, rec


DENSE_LAYERS_ID = 2               # (a): the identity drives' depth
DENSE_VOCAB_ID = 512              # (a): their vocabulary (8B width else)
DENSE_T_ID = 512                  # (a): max_seq_len of the dense drives
DENSE_HEAD_ID = 32                # (a): the registered head's tokens
DENSE_TAILS_ID = (20, 60)         # (a): the head's prompts' own tokens
DENSE_PLAIN_ID = (40, 110)        # (a): prompts without the head
DENSE_NEW_ID = 10                 # (a): tokens a stream
DENSE_CHUNK_ID = 32               # (a): --prefill-chunk of the chunked drive
DENSE_RING_W_ID = 32              # (a): the ring's window ...
DENSE_RING_T_ID = 128             # ... and max_seq_len
DENSE_RING_PROMPTS_ID = (40, 70)  # (a): both longer than the window
DENSE_RING_NEW_ID = 24            # (a): streams past another wrap
DENSE_SLOTS = 8                   # (b), (d)
DENSE_T = 4096                    # (b), (d): max_seq_len
DENSE_SYSTEM = 400                # (b): the shared system message's tokens
DENSE_USER = 600                  # (b): each chat's own message
DENSE_NEW = 64                    # (b)-(d): tokens a chat
RING_W = 4096                     # (c): Mistral-7B's window ...
RING_T = 8192                     # ... at twice its length
RING_PROMPT = 5000                # (c): tokens a chat's prompt
DENSE_DRAFT_LAYERS = 4            # (d): the draft, the target's first blocks
DENSE_GAMMA = 4                   # (d)


def _dense_f32(torch, cfg, seed: int, layers: int):
    """A model at cfg's width with `layers` layers and f32 weights drawn
    on the host from a seed (the CPU engine gets them as they are, the
    card a copy), the lm_head past the byte range zeroed as
    `_f32_params` does."""
    import dataclasses

    from cake_tpu_torch.models.llama.params import init_params

    c = dataclasses.replace(cfg, num_hidden_layers=layers)
    p = init_params(c, torch.Generator().manual_seed(seed), device="cpu",
                    dtype=torch.float32)
    p["lm_head"][:, 256:] = 0.0
    on = {k: ({n: t.to(DEV) for n, t in v.items()}
              if isinstance(v, dict) else v.to(DEV))
          for k, v in p.items()}
    return c, p, on


def _dense_engine(torch, cfg, params, device, **kw):
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    kw.setdefault("max_slots", 4)
    kw.setdefault("max_seq_len", DENSE_T_ID)
    return InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), device=device,
        cache_dtype=torch.float32,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0),
        recovery=True, **kw)


def _dense_streams(eng, prompts, n_new: int, head=None, warm: bool = False,
                   switches=()):
    """Every prompt submitted before the engine starts (the head
    registered first); with `switches`, each applied once the first
    stream has 4 more tokens; with `warm`, a second wave of the same
    prompts after the first. Returns (the waves' greedy streams, the
    captures each wave made)."""
    captures = _count_captures(eng)
    waves, caps = [], []
    if head is not None:
        eng.register_prefix(list(head))
    hs = [eng.submit(list(p), max_new_tokens=n_new) for p in prompts]
    with eng:
        for i, c in enumerate(switches):
            deadline = time.monotonic() + 300
            while (len(hs[0]._req.out_tokens) < 4 * (i + 1)
                   and time.monotonic() < deadline):
                time.sleep(0.0005)
            if hs[0]._req.done.is_set():
                fail(f"dense: a stream finished before switch {i + 1}")
            if not eng.reconfigure(c):
                fail(f"dense: switch {i + 1} to {c} was a no-op")
        for wave in range(2 if warm else 1):
            if wave:
                hs = [eng.submit(list(p), max_new_tokens=n_new)
                      for p in prompts]
            for h in hs:
                if not h.wait(900) or h._req.error is not None:
                    fail(f"dense: a stream failed ({h._req.error})")
            waves.append([list(h._req.out_tokens) for h in hs])
            caps.append(len(captures) - sum(caps))
    return waves, caps


def _dense_flash_held(torch, fa, cfg, p_cpu, p_dev, card: str) -> dict:
    """The dense prefills' flash launches held against the kernels' plain
    versions: a whole-prompt `prefill_slot` (flash_attn) and a chunk
    window of `prefill_slot_chunk` at an unaligned pos0 (flash_attn_cached
    over the slot's lines), each replayed from its captured graph on the
    card, against the same step on the host, where the wrappers run their
    plain versions. One launch a layer a replay."""
    from cake_tpu_torch.models.llama import model as tm
    from cake_tpu_torch.models.llama.cache import KVCache
    from cake_tpu_torch.serve.graphs import DensePrefillRunner

    g = torch.Generator().manual_seed(21)
    shape = (cfg.num_hidden_layers, 3, DENSE_T_ID, cfg.num_key_value_heads,
             cfg.head_dim)
    host = KVCache(0.5 * torch.randn(shape, generator=g),
                   0.5 * torch.randn(shape, generator=g))
    card_c = KVCache(host.k.to(DEV), host.v.to(DEV))
    runner = DensePrefillRunner(p_dev, card_c,
                                tm.RopeTables.create(cfg, DENSE_T_ID,
                                                     device=DEV), cfg)
    rope_h = tm.RopeTables.create(cfg, DENSE_T_ID, device="cpu")
    ids = [(11 * j) % 250 + 3 for j in range(100)]
    out = {}
    for name, variant, n, slot, pos0 in (
            ("flash_attn", ("slot", 128), 100, 1, 0),
            ("flash_attn_cached", ("chunk", 64), 61, 2, 173)):
        S = variant[1]
        win = (ids + [0] * S)[:S] if variant[0] == "slot" else \
            (ids[:n] + [0] * S)[:S]
        runner.run(variant, win, n, slot, pos0)       # the capture
        fa.reset_launch_counts()
        got = runner.run(variant, win, n, slot, pos0).clone()
        launched = fa.LAUNCHES[name]
        torch.cuda.synchronize()
        toks = torch.tensor([win], dtype=torch.int32)
        n_t = torch.tensor([n], dtype=torch.int32)
        if variant[0] == "slot":
            want, _ = tm.prefill_slot(p_cpu, toks, n_t, slot, host, rope_h,
                                      cfg)
        else:
            want, _ = tm.prefill_slot_chunk(p_cpu, toks, n_t, slot, pos0,
                                            host, rope_h, cfg)
        plain = fa.LAUNCHES[name + "_plain"]
        err = (got.cpu() - want).abs().max().item()
        cache_err = max((card_c.k[:, slot].cpu() - host.k[:, slot]).abs()
                        .max().item(), (card_c.v[:, slot].cpu()
                                        - host.v[:, slot]).abs().max().item())
        scale = want.abs().max().item()
        out[name] = dict(launches=launched, plain_calls=plain,
                         max_abs_err=err, cache_max_abs_err=cache_err,
                         logit_scale=scale)
        log(f"dense (a) {name} in a replayed {variant}: {launched} launches,"
            f" max |logits - plain| {err:.3g} (|logits| up to {scale:.3g}),"
            f" slot lines {cache_err:.3g} [{card}]")
        if launched != cfg.num_hidden_layers or plain != cfg.num_hidden_layers:
            fail(f"dense (a) {name}: {launched} replayed and {plain} plain "
                 f"launches, expected {cfg.num_hidden_layers} each")
        if err > 1e-4 * max(1.0, scale) or cache_err > 1e-4:
            fail(f"dense (a) {name}: the replay is not the plain version's "
                 f"({out[name]})")
    return out


def _dense_identity(torch, fa, rpa, i4, card: str) -> dict:
    """(a) 8B width, 2 layers, a 512-token vocabulary, f32 weights and
    cache: the dense flash launches inside replayed prefills against
    their plain versions; then every card engine's greedy streams
    against the CPU engine's (flash off there, so the host drives, run
    on a thread meanwhile, launch no kernel and call no plain version):
    the dense engine with whole-prompt prefills and prefix hits at
    --decode-scan 1 and 4, with --prefill-chunk windows, installs and
    hits at 4 (a warm wave capturing nothing); the ring engine with a
    32-slot window, prompts and streams past it (a warm wave); the dense
    spec engine with a self-draft (a warm wave) and a mismatched 1-layer
    draft; and one paged engine switched to the dense engine and back
    under load. No plain version on the card."""
    import dataclasses

    from cake_tpu_torch.models.llama.config import LlamaConfig

    t0 = time.perf_counter()
    base = dataclasses.replace(LlamaConfig.llama3_8b(),
                               vocab_size=DENSE_VOCAB_ID)
    cfg, p_cpu, p_dev = _dense_f32(torch, base, 15, DENSE_LAYERS_ID)
    dcfg, d_cpu, d_dev = _dense_f32(torch, base, 16, 1)
    flash = dataclasses.replace(cfg, use_flash_attention=True)
    rec = dict(flash=_dense_flash_held(torch, fa, flash, p_cpu, p_dev,
                                       card))
    head = [(5 * j) % 250 + 3 for j in range(DENSE_HEAD_ID)]
    prompts = [head + [(7 * i + 3 * j) % 250 + 3 for j in range(n)]
               for i, n in enumerate(DENSE_TAILS_ID)] + [
        [(11 * i + 7 * j + 1) % 250 + 3 for j in range(n)]
        for i, n in enumerate(DENSE_PLAIN_ID)]
    ring = dataclasses.replace(cfg, sliding_window=DENSE_RING_W_ID)
    ring_prompts = [[(13 * i + 7 * j) % 250 + 3 for j in range(n)]
                    for i, n in enumerate(DENSE_RING_PROMPTS_ID)]
    spec_prompts = prompts[2:]
    # drive -> (card engine, its kwargs, the CPU drive it must equal)
    # "whole scan1" (decode_scan 1) cut for the smoke's time
    # budget: scan 4's bursts replay the same step
    drives = {
        "whole scan4": (flash, dict(decode_scan_steps=4), "whole"),
        "chunked scan4": (flash, dict(decode_scan_steps=4,
                                      prefill_chunk=DENSE_CHUNK_ID),
                          "chunked"),
        "ring": (dataclasses.replace(ring, use_flash_attention=True),
                 dict(decode_scan_steps=4, max_seq_len=DENSE_RING_T_ID),
                 "ring"),
        "spec self": (flash, dict(draft_params=p_dev, draft_config=flash,
                                  spec_gamma=3), "spec self"),
        "spec mismatched": (flash, dict(draft_params=d_dev,
                                        draft_config=dcfg, spec_gamma=3),
                            "spec mismatched"),
        "switch": (flash, dict(kv_pages=32, kv_page_size=16,
                               decode_scan_steps=4), "switch"),
    }
    # the host's drives (flash off: the einsum, no kernel counter moves)
    host = {
        "whole": (cfg, dict(), prompts, DENSE_NEW_ID, head),
        "chunked": (cfg, dict(prefill_chunk=DENSE_CHUNK_ID), prompts,
                    DENSE_NEW_ID, head),
        "ring": (ring, dict(max_seq_len=DENSE_RING_T_ID), ring_prompts,
                 DENSE_RING_NEW_ID, None),
        "spec self": (cfg, dict(draft_params=p_cpu, draft_config=cfg,
                                spec_gamma=3), spec_prompts, DENSE_NEW_ID,
                      None),
        "spec mismatched": (cfg, dict(draft_params=d_cpu, draft_config=dcfg,
                                      spec_gamma=3), spec_prompts,
                            DENSE_NEW_ID, None),
        "switch": (cfg, dict(), prompts, 2 * DENSE_NEW_ID + 4, None),
    }
    box = {}

    def host_run():
        for key, (c, kw, ps, n, h) in host.items():
            try:
                box[key] = _dense_streams(_dense_engine(torch, c, p_cpu,
                                                        "cpu", **kw),
                                          ps, n, head=h)[0][0]
            except BaseException as e:   # noqa: BLE001 — reported below
                box[key] = repr(e)

    fa.reset_launch_counts()
    plain0 = {k: n for c in (rpa.LAUNCHES, fa.LAUNCHES, i4.LAUNCHES)
              for k, n in c.items() if k.endswith("_plain")}
    t_host = threading.Thread(target=host_run)
    t_host.start()
    got = {}
    for name, (c, kw, key) in drives.items():
        _, _, ps, n, h = host[key]
        if name.startswith("spec") or name == "ring":
            h = None
        eng = _dense_engine(torch, c, p_dev, DEV, **kw)
        flavor = eng.flight.impl
        switches = ((dict(slots=4, decode_scan=4),
                     dict(slots=4, decode_scan=4, kv_pages=32,
                          kv_page_size=16)) if name == "switch" else ())
        warm = name in ("chunked scan4", "ring", "spec self")
        waves, caps = _dense_streams(eng, ps, n, head=h, warm=warm,
                                     switches=switches)
        got[name] = dict(flavor=flavor, streams=waves[0], captures=caps,
                         epoch=eng.config_epoch,
                         prefix_hits=eng.stats.prefix_hits)
        if warm and (waves[1] != waves[0] or caps[1]):
            fail(f"dense (a) {name}: the warm wave captured {caps[1]} "
                 f"graph(s) or changed the streams")
        if name == "switch" and (eng.config_epoch != 2 or not eng.paged):
            fail(f"dense (a) switch: epoch {eng.config_epoch}, paged "
                 f"{eng.paged}")
        del eng
    launches = {k: n for k, n in fa.LAUNCHES.items() if n}
    t_host.join(timeout=900)
    plain1 = {k: n for c in (rpa.LAUNCHES, fa.LAUNCHES, i4.LAUNCHES)
              for k, n in c.items() if k.endswith("_plain")}
    moved = {k: plain1[k] - plain0.get(k, 0) for k in plain1
             if plain1[k] != plain0.get(k, 0)}
    for name, (_, _, key) in drives.items():
        ref = box.get(key)
        same = got[name]["streams"] == ref
        got[name]["cpu_identical"] = same
        log(f"dense (a) {name:<16} [{got[name]['flavor']}]: == CPU engine "
            f"{same}, captures by wave {got[name]['captures']}, prefix hits "
            f"{got[name]['prefix_hits']} [{card}]")
        if not same:
            fail(f"dense (a) {name}: the card's streams "
                 f"{got[name]['streams']} are not the CPU engine's {ref}")
    # two hits a wave (the chunked engine runs two waves)
    if got["whole scan4"]["prefix_hits"] != 2 or \
            got["chunked scan4"]["prefix_hits"] != 4:
        fail("dense (a): the head's prompts did not hit the prefix")
    for k in ("flash_attn", "flash_attn_cached"):
        if launches.get(k, 0) <= 0:
            fail(f"dense (a): {k} never launched on the card")
    if moved:
        fail(f"dense (a): plain versions ran on the card: {moved}")
    rec.update(drives=got, launches=launches,
               seconds=time.perf_counter() - t0)
    log(f"dense (a): flash launches {launches}, no plain version; "
        f"{rec['seconds']:.1f} s")
    return rec


def _dense_wave(srv, tag: str, head: str) -> dict:
    """Six chats of about DENSE_SYSTEM + DENSE_USER tokens and DENSE_NEW
    new ones at once through the HTTP API: three share the system
    message `head` (with --auto-prefix, prefix hits: the head's KV
    installed, the suffix prefilled after it), three carry all their
    tokens in the user message (whole-prompt prefills). The served
    requests' TTFT p50 and decode tok/s, and the decode replays' device
    ms (the flight records of single decode steps)."""
    eng = srv.engine
    n0, tok0, dec0 = len(eng.retired), eng.stats.tokens_generated, \
        eng.stats.decode_time_s
    r0 = len(eng.flight.records())
    t_wave = time.perf_counter()
    tags = [f"{tag}{i}" for i in range(6)]
    for i, t in enumerate(tags):
        if i % 2:
            srv.post(t, "standard", DENSE_SYSTEM + DENSE_USER, DENSE_NEW)
        else:
            srv.post(t, "standard", DENSE_USER, DENSE_NEW, head=head)
    srv.join()
    wall = time.perf_counter() - t_wave
    bad = {t: srv.status.get(t) for t in tags
           if srv.status.get(t, (0,))[0] != 200}
    if bad:
        fail(f"dense (b) [{tag}]: chats failed {bad}")
    retired = list(eng.retired)[n0:]
    if len(retired) != 6 or any(len(r.out_tokens) != DENSE_NEW
                                for r in retired):
        fail(f"dense (b) [{tag}]: expected six chats of {DENSE_NEW} tokens")
    dec_s = eng.stats.decode_time_s - dec0
    recs = eng.flight.records()[r0:]
    dev = [r.device_s for r in recs if r.kind == "decode" and r.device_s]
    return dict(
        wall_s=wall, ttft_p50_s=statistics.median(
            r.first_token_t - r.submit_t for r in retired),
        decode_tok_s=((eng.stats.tokens_generated - tok0) / dec_s
                      if dec_s else 0.0),
        decode_replay_ms=(1e3 * statistics.median(dev) if dev else None),
        prompt_tokens=[len(r.prompt_ids) for r in retired],
        streams=[list(r.out_tokens) for r in retired],
        prompts=[list(r.prompt_ids) for r in retired])


def _dense_served(torch, fa, rpa, cfg, params, card: str):
    """(b) the bf16 weights (cut to CUT_LAYERS) behind the HTTP API: the
    dense
    engine Master.make_engine builds with --kv-pages unset (8 slots at
    max_seq_len 4096: a 4 GiB cache) with --auto-prefix, and beside it
    the paged engine (128 x 128-token pages) on the same waves: a warm-up
    wave, then a measured one (the counts set to 0 just before it); then
    `_dense_flash_bf16` at the keys that wave replayed. Returns (the
    dense measured wave's flash launches, records)."""
    head = " ".join(f"s{i}" for i in range(DENSE_SYSTEM))[:DENSE_SYSTEM]
    records, dense_launches = {}, {}
    for label, pages in (("dense", None), ("paged", 128)):
        srv = _SchedServer(torch, cfg, params, torch.bfloat16, False,
                           max_seq_len=DENSE_T, kv_pages=pages,
                           prefill_chunk=None, decode_scan=1,
                           auto_prefix=True)
        eng = srv.engine
        try:
            if (eng.paged, eng.flight.impl) != (
                    pages is not None,
                    "dense" if pages is None else "paged-kernel"):
                fail(f"dense (b): make_engine built {eng.flight.impl}")
            caps = _count_captures(eng)
            _dense_wave(srv, f"w{label[0]}", head)
            fa.reset_launch_counts()
            rpa.reset_launch_counts()
            del caps[:]
            rec = _dense_wave(srv, f"m{label[0]}", head)
            rec.update(label=label, captures=len(caps),
                       launches={k: n for k, n in {
                           **fa.LAUNCHES, **rpa.LAUNCHES}.items() if n},
                       cache_gib=eng.cache.memory_bytes() / 2**30,
                       prefix_hits=eng.stats.prefix_hits)
            if label == "dense":
                dense_launches = {k: n for k, n in fa.LAUNCHES.items() if n}
                variants = [v for v in eng._prefill_runner._bufs
                            if v[0] in ("slot", "prefixed")]
                for k in ("flash_attn", "flash_attn_cached"):
                    if rec["launches"].get(k, 0) <= 0:
                        fail(f"dense (b): {k} never launched")
                if rec["prefix_hits"] < 3:
                    fail(f"dense (b): {rec['prefix_hits']} prefix hits, "
                         "expected the system chats' 3 at least")
            if rec["captures"]:
                fail(f"dense (b) {label}: the measured wave captured "
                     f"{rec['captures']} graph(s)")
            plain = {k: n for k, n in rec["launches"].items()
                     if k.endswith("_plain")}
            if plain:
                fail(f"dense (b) {label}: plain versions ran {plain}")
            records[label] = rec
            log(f"dense (b) {label:<6}: TTFT p50 {rec['ttft_p50_s']:.3f} s, "
                f"decode {rec['decode_tok_s']:.1f} tok/s, decode replay "
                f"{rec['decode_replay_ms']} ms, wall {rec['wall_s']:.2f} s, "
                f"cache {rec['cache_gib']:.3f} GiB, prefix hits "
                f"{rec['prefix_hits']}, launches {rec['launches']} [{card}]")
        finally:
            srv.close()
        # the serving thread ends once its shutdown has stopped the engine;
        # then nothing holds the engine but these names (the handler
        # class holds the server weakly)
        for t in threading.enumerate():
            if t.name == "cake-http":
                t.join(timeout=60)
        gone = [weakref.ref(eng)]
        del srv, eng
        _release(torch, gone)
    same = sum(a == b for a, b in zip(records["dense"]["streams"],
                                      records["paged"]["streams"]))
    records["dense_equals_paged"] = same
    log(f"dense (b): {same} of 6 bf16 streams equal the paged engine's "
        "(printed, not gated: bf16 near-ties)")
    records["flash_bf16"] = _dense_flash_bf16(torch, fa, cfg, params,
                                              variants, card)
    return dense_launches, records


# layer 1's lines after one bf16 attention of each route, held to a share
# of their largest magnitude (bf16's rtol): elementwise, a line near 0
# inherits the rounding of the larger values it is projected from
L1_REL_TOL = TOL["bfloat16"]["rtol"]


def _dense_flash_bf16(torch, fa, cfg, params, variants, card: str) -> dict:
    """(b)'s bf16 flash bodies held inside its own steps: the largest
    `prefill_slot` bucket and `prefill_slot_prefixed` key that its
    measured wave replayed (`variants`), each captured and replayed over
    a random bf16 cache of (b)'s shape (DENSE_SLOTS slots at DENSE_T),
    against the same step run eagerly with flash off (the einsum) on the
    same card inputs from a clone of that cache. 32 layers of bf16
    rounding part the two routes as in the prefix phase (flash rounds p
    to bf16, the einsum keeps it in f32), so logits and the slot's lines
    are held to PREFIX_REL_TOL of their largest magnitude, and layer 1's
    lines, one attention in, to L1_REL_TOL of theirs; layer 0's lines (and a
    prefix's P positions: a head prefilled with flash off, as the
    registry holds it) are written before any attention and must be
    identical, and every other slot must keep its lines."""
    import dataclasses

    from cake_tpu_torch.models.llama import model as tm
    from cake_tpu_torch.models.llama.cache import KVCache
    from cake_tpu_torch.serve.graphs import DensePrefillRunner

    picks = {kind: max((v for v in variants if v[0] == kind),
                       key=lambda v: v[-1], default=None)
             for kind in ("slot", "prefixed")}
    if None in picks.values():
        fail(f"dense (b): the measured wave replayed {variants}, expected "
             "a prefill_slot and a prefill_slot_prefixed key")
    gen = torch.Generator(device=DEV).manual_seed(23)
    L, KV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    shape = (L, DENSE_SLOTS, DENSE_T, KV, hd)

    def lines(s):
        return 0.5 * torch.randn(s, generator=gen, device=DEV,
                                 dtype=torch.bfloat16)

    cache = KVCache(lines(shape), lines(shape))
    rope = tm.RopeTables.create(cfg, DENSE_T, device=DEV)
    plain_cfg = dataclasses.replace(cfg, use_flash_attention=False)
    runner = DensePrefillRunner(params, cache, rope, cfg)
    out = {}
    for (kind, variant), slot, kern in zip(
            picks.items(), (5, 6), ("flash_attn", "flash_attn_cached")):
        S = variant[-1]
        n = S - 24
        ids = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                            device=DEV, dtype=torch.int32)
        ids[:, n:] = 0
        prefix = None
        if kind == "prefixed":
            # a registered head's lines, as the engine's registry holds
            # them: the head prefilled (flash off) into the last slot
            P = variant[1]
            head = torch.randint(0, cfg.vocab_size, (1, P), generator=gen,
                                 device=DEV, dtype=torch.int32)
            tm.prefill_slot(params, head, torch.tensor(
                [P], dtype=torch.int32, device=DEV), DENSE_SLOTS - 1, cache,
                rope, plain_cfg)
            prefix = (cache.k[:, -1:, :P].clone(), cache.v[:, -1:, :P].clone())
        ref = KVCache(cache.k.clone(), cache.v.clone())
        runner.run(variant, ids[0].tolist(), n, slot, prefix=prefix)
        fa.reset_launch_counts()
        got = runner.run(variant, ids[0].tolist(), n, slot,
                         prefix=prefix).clone()
        replayed = {k: c for k, c in fa.LAUNCHES.items() if c}
        fa.reset_launch_counts()
        n_t = torch.tensor([n], dtype=torch.int32, device=DEV)
        if kind == "slot":
            want, _ = tm.prefill_slot(params, ids, n_t, slot, ref, rope,
                                      plain_cfg)
        else:
            want, _ = tm.prefill_slot_prefixed(params, ids, n_t, slot,
                                               *prefix, ref, rope, plain_cfg)
        torch.cuda.synchronize()
        eager = {k: c for k, c in fa.LAUNCHES.items() if c}
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        line_err, line_scale, l0_same, others_same = 0.0, 0.0, True, True
        l1_err, l1_scale = 0.0, 0.0
        for a, b in ((cache.k, ref.k), (cache.v, ref.v)):
            x, y = a[:, slot].float(), b[:, slot].float()
            line_err = max(line_err, (x - y).abs().max().item())
            line_scale = max(line_scale, y.abs().max().item())
            # layer 1's lines follow one attention of each route: a fault
            # of the body shows there beyond bf16 rounding
            l1_err = max(l1_err, (x[1] - y[1]).abs().max().item())
            l1_scale = max(l1_scale, y[1].abs().max().item())
            l0_same &= torch.equal(a[0, slot], b[0, slot])
            if prefix is not None:
                l0_same &= torch.equal(a[:, slot, :variant[1]],
                                       b[:, slot, :variant[1]])
            others_same &= (torch.equal(a[:, :slot], b[:, :slot])
                            and torch.equal(a[:, slot + 1:], b[:, slot + 1:]))
            del x, y
        l1_close = l1_err <= L1_REL_TOL * l1_scale
        out[kind] = dict(variant=list(variant), launches=replayed,
                         max_abs_err=err, logit_scale=scale,
                         lines_max_abs_err=line_err, lines_scale=line_scale,
                         layer0_identical=l0_same,
                         layer1_max_abs_err=l1_err, layer1_close=l1_close,
                         other_slots_kept=others_same)
        log(f"dense (b) bf16 {kind} {variant}, slot {slot}: replay "
            f"launches {replayed}; max |logits - flash off| {err:.3e} "
            f"({err / scale:.3e} of {scale:.3e}), slot lines "
            f"{line_err:.3e} ({line_err / line_scale:.3e} of "
            f"{line_scale:.3e}), tol {PREFIX_REL_TOL}; layer 1's lines "
            f"{l1_err:.3e} ({l1_err / l1_scale:.3e} of {l1_scale:.3e}, tol "
            f"{L1_REL_TOL}); layer 0"
            f"{' and the prefix' if prefix else ''} identical {l0_same}, "
            f"other slots kept {others_same} [{card}]")
        if (replayed != {kern: L} or eager or not torch.isfinite(got).all()
                or err > PREFIX_REL_TOL * scale
                or line_err > PREFIX_REL_TOL * line_scale or not l1_close
                or not l0_same or not others_same):
            fail(f"dense (b) bf16 {kind}: {out[kind]} (the flash-off side "
                 f"launched {eager})")
        del ref
    del runner, cache
    torch.cuda.empty_cache()
    return out


def _byte_tok(cfg):
    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    return ByteTokenizer(cfg.vocab_size)


def _dense_ring(torch, cfg, params, card: str) -> dict:
    """(c) the same weights with Mistral-7B's window (sliding_window 4096)
    at max_seq_len 8192: the ring engine (W = 4096 slots, 512 MiB a slot
    where a dense row would take 1 GiB), two chats of RING_PROMPT-token
    prompts that wrap the ring (windows of 512) and DENSE_NEW new tokens,
    after a warm-up chat."""
    import dataclasses

    ring_cfg = dataclasses.replace(cfg, sliding_window=RING_W)
    eng = _bf16_engine(torch, ring_cfg, params, max_slots=2,
                       max_seq_len=RING_T)
    if not eng.ring or eng.cache.max_seq_len != RING_W:
        fail(f"dense (c): not a {RING_W}-slot ring engine")
    caps = _count_captures(eng)
    prompts = [[(7 * i + 3 * j) % (cfg.vocab_size // 4) + 100
                for j in range(RING_PROMPT)] for i in range(2)]
    with eng:
        h = eng.submit(prompts[0][:700], max_new_tokens=8)
        if not h.wait(600) or h._req.error is not None:
            fail(f"dense (c): the warm-up chat failed ({h._req.error})")
        del caps[:]
        n0, tok0, dec0 = len(eng.retired), eng.stats.tokens_generated, \
            eng.stats.decode_time_s
        t_wave = time.perf_counter()
        hs = [eng.submit(p, max_new_tokens=DENSE_NEW) for p in prompts]
        for h in hs:
            if not h.wait(900) or h._req.error is not None:
                fail(f"dense (c): a chat failed ({h._req.error})")
        wall = time.perf_counter() - t_wave
    retired = list(eng.retired)[n0:]
    dec_s = eng.stats.decode_time_s - dec0
    per_slot = eng.cache.memory_bytes() / 2
    dense_slot = per_slot * RING_T / RING_W
    rec = dict(
        wall_s=wall, captures=len(caps),
        ttft_p50_s=statistics.median(r.first_token_t - r.submit_t
                                     for r in retired),
        decode_tok_s=((eng.stats.tokens_generated - tok0) / dec_s
                      if dec_s else 0.0),
        ring_bytes=eng.cache.memory_bytes(), ring_bytes_a_slot=per_slot,
        dense_bytes_a_slot=dense_slot,
        tokens=[len(r.out_tokens) for r in retired])
    if rec["tokens"] != [DENSE_NEW] * 2 or any(
            not 0 <= t < cfg.vocab_size for r in retired
            for t in r.out_tokens):
        fail(f"dense (c): bad streams {rec['tokens']}")
    if rec["captures"]:
        fail(f"dense (c): the measured wave captured {rec['captures']}")
    log(f"dense (c) ring W={RING_W} at max_seq_len {RING_T}: two "
        f"{RING_PROMPT}-token chats, TTFT p50 {rec['ttft_p50_s']:.3f} s, "
        f"decode {rec['decode_tok_s']:.1f} tok/s, wall {wall:.2f} s; the "
        f"ring {per_slot / 2**20:.0f} MiB a slot where a dense row takes "
        f"{dense_slot / 2**20:.0f} MiB [{card}]")
    gone = [weakref.ref(eng)]
    del eng
    _release(torch, gone)
    return rec


def _bf16_engine(torch, cfg, params, **kw):
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    return InferenceEngine(
        cfg, params, _byte_tok(cfg), device=DEV, cache_dtype=torch.bfloat16,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0), **kw)


def _dense_spec(torch, cfg, params, plain: dict, card: str) -> dict:
    """(d) the dense spec engine at full width: the target's first
    DENSE_DRAFT_LAYERS blocks as the draft, gamma DENSE_GAMMA, 8 slots at
    max_seq_len 4096, (b)'s six prompts and DENSE_NEW tokens, after a
    warm-up wave: acceptance, tokens a round and tok/s beside (b)'s plain
    dense engine."""
    d_cfg, d_params = _cut_draft(cfg, params, DENSE_DRAFT_LAYERS)
    eng = _bf16_engine(torch, cfg, params, max_slots=DENSE_SLOTS,
                       max_seq_len=DENSE_T, draft_params=d_params,
                       draft_config=d_cfg, spec_gamma=DENSE_GAMMA)
    caps = _count_captures(eng)
    prompts = plain["prompts"]
    with eng:
        for wave in ("warm-up", "measured"):
            if wave == "measured":
                del caps[:]
                p0, a0 = eng.stats.spec_proposed, eng.stats.spec_accepted
                r0 = len(eng.flight.records())
                tok0, dec0 = eng.stats.tokens_generated, \
                    eng.stats.decode_time_s
            hs = [eng.submit(p, max_new_tokens=DENSE_NEW) for p in prompts]
            for h in hs:
                if not h.wait(900) or h._req.error is not None:
                    fail(f"dense (d): a chat failed ({h._req.error})")
    rounds = [r for r in eng.flight.records()[r0:] if r.kind == "spec"]
    proposed = eng.stats.spec_proposed - p0
    dec_s = eng.stats.decode_time_s - dec0
    streams = [list(h._req.out_tokens) for h in hs]
    rec = dict(
        captures=len(caps), rounds=len(rounds),
        acceptance=((eng.stats.spec_accepted - a0) / proposed
                    if proposed else None),
        tokens_a_round=(sum(r.tokens for r in rounds)
                        / max(1, sum(r.rows for r in rounds))),
        decode_tok_s=((eng.stats.tokens_generated - tok0) / dec_s
                      if dec_s else 0.0),
        plain_decode_tok_s=plain["decode_tok_s"],
        round_device_ms=(1e3 * statistics.median(
            r.device_s for r in rounds if r.device_s)
            if any(r.device_s for r in rounds) else None),
        equal_to_plain=sum(a == b for a, b in zip(streams,
                                                   plain["streams"])),
        draft_cache_gib=eng.d_cache.memory_bytes() / 2**30)
    if rec["captures"]:
        fail(f"dense (d): the measured wave captured {rec['captures']}")
    if any(len(s) != DENSE_NEW for s in streams):
        fail("dense (d): a stream stopped short")
    log(f"dense (d) spec, draft = the first {DENSE_DRAFT_LAYERS} blocks, "
        f"gamma {DENSE_GAMMA}: acceptance {rec['acceptance']}, "
        f"{rec['tokens_a_round']:.2f} tokens a row a round, "
        f"{rec['rounds']} rounds (device {rec['round_device_ms']} ms a "
        f"round), decode {rec['decode_tok_s']:.1f} tok/s against the plain "
        f"dense engine's {rec['plain_decode_tok_s']:.1f}; "
        f"{rec['equal_to_plain']} of 6 streams equal (b)'s (printed, "
        f"not gated) [{card}]")
    gone = [weakref.ref(eng)]
    del eng
    _release(torch, gone)
    return rec


def phase_dense(torch, rpa, fa, i4, cfg, params, card: str,
                after_identity=None):
    """The dense phase: (a) the identities at 2 layers, f32, (b) the dense
    engine served at full width beside the paged engine, (c) the ring at
    Mistral-7B's window, (d) the dense spec engine. Returns ((b)'s
    measured dense wave's launches, record)."""
    import dataclasses

    t0 = time.perf_counter()
    _release(torch)
    held = torch.cuda.memory_allocated()
    rec = dict(identity=_dense_identity(torch, fa, rpa, i4, card))
    if after_identity is not None:
        after_identity()     # a child that ran meanwhile, joined
    _release(torch)
    # flash prefills, as the context turns them on for a card
    cfg = dataclasses.replace(cfg, use_flash_attention=True)
    counts, rec["served"] = _dense_served(torch, fa, rpa, cfg, params, card)
    rec["ring"] = _dense_ring(torch, cfg, params, card)
    rec["spec"] = _dense_spec(torch, cfg, params, rec["served"]["dense"],
                              card)
    for r in ("dense", "paged"):
        rec["served"][r].pop("prompts", None)
        rec["served"][r].pop("streams", None)
    rec["seconds"] = time.perf_counter() - t0
    _release(torch)
    rec["held_gib"] = [held / 2**30, torch.cuda.memory_allocated() / 2**30]
    if torch.cuda.memory_allocated() > held + 2**30:
        fail(f"dense: the phase kept {rec['held_gib']} GiB allocated")
    log(f"dense phase: {rec['seconds']:.1f} s (identity "
        f"{rec['identity']['seconds']:.1f} s)")
    return counts, rec


# -- phase: moe -----------------------------------------------------------------

MOE_W_ID = 16                     # (a): the ring flavor's window
MOE_T_ID = 64                     # (a): max_seq_len of the identity drives
MOE_PROMPTS_ID = (20, 37, 9)      # (a): prompt tokens (two past the window)
MOE_NEW_ID = 12                   # (a): tokens a stream
MOE_LAYERS = 4                    # (b): Mixtral-8x7B's 32 layers cut to 4
MOE_CHATS = (160, 400, 180, 200, 300, 140)   # (b): each chat's prompt
MOE_NEW = 64                      # (b): tokens a chat
MOE_WARM_MAX = 4                  # (b): warm-up waves at most
MOE_OFF_CHUNK = 256               # (b) off: prompts past it walk windows
# (b)'s drives: weights, engine Args beside the common ones, and the
# kernels each measured wave must launch (its KERNELS rows)
MOE_DRIVES = {
    "bf16": ("bf16", dict(prefill_chunk=None),
             ("rpa_decode", "rpa_mixed")),
    "int8": ("int8", dict(prefill_chunk=None, kv_dtype="int8"),
             ("rpa_decode_q8", "rpa_mixed_q8")),
    "off": ("bf16", dict(prefill_chunk=MOE_OFF_CHUNK, mixed_batch="off"),
            ("rpa_decode", "flash_attn", "flash_attn_cached")),
}
MOE_FLAVORS = {
    "paged-auto-1": dict(kv_pages=24, kv_page_size=16, prefill_chunk=8,
                         mixed_batch="auto", decode_scan_steps=1),
    "paged-auto-4": dict(kv_pages=24, kv_page_size=16, prefill_chunk=8,
                         mixed_batch="auto", decode_scan_steps=4),
    "paged-off-1": dict(kv_pages=24, kv_page_size=16, prefill_chunk=8,
                        mixed_batch="off", decode_scan_steps=1),
    "paged-off-4": dict(kv_pages=24, kv_page_size=16, prefill_chunk=8,
                        mixed_batch="off", decode_scan_steps=4),
    "dense": dict(prefill_chunk=8, decode_scan_steps=4),
    "ring": dict(decode_scan_steps=4),
    "spec": dict(kv_pages=24, kv_page_size=16, prefill_chunk=8,
                 spec_gamma=3),
}


def _moe_engine(torch, cfg, params, device, flavor: str):
    """One MoE engine flavor of (a): greedy, f32 cache."""
    import dataclasses

    from cake_tpu_torch.models.llama.generator import ByteTokenizer
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.serve.engine import InferenceEngine

    kw = dict(MOE_FLAVORS[flavor])
    if flavor == "ring":
        cfg = dataclasses.replace(cfg, sliding_window=MOE_W_ID)
    if flavor == "spec":
        kw.update(spec_draft_params=params, spec_draft_config=cfg)
    return InferenceEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), device=device,
        max_slots=3, max_seq_len=MOE_T_ID, cache_dtype=torch.float32,
        sampling=SamplingConfig(temperature=0.0, repeat_penalty=1.0), **kw)


def _moe_identity(torch, card: str) -> dict:
    """(a) the tiny MoE (2 layers, 4 experts, top 2) at f32, the weights
    drawn on the host from a seed: each engine flavor on the card
    against the same flavor on the CPU over two waves (the second
    capturing nothing), and the generator's replayed decode steps
    against the CPU generator's."""
    import numpy as np

    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.models.moe import MoEConfig
    from cake_tpu_torch.models.moe.params import init_params
    from cake_tpu_torch.ops.sampling import SamplingConfig

    t0 = time.perf_counter()
    cfg = MoEConfig.tiny()
    p_cpu = init_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                        dtype=torch.float32)
    p_dev = {k: ({n: t.to(DEV) for n, t in v.items()}
                 if isinstance(v, dict) else v.to(DEV))
             for k, v in p_cpu.items()}
    prompts = [[(7 * i + 3 * j) % 200 + 3 for j in range(n)]
               for i, n in enumerate(MOE_PROMPTS_ID)]
    rec = {}
    for flavor in MOE_FLAVORS:
        want = None
        streams = []
        for side, (device, p) in enumerate((("cpu", p_cpu), (DEV, p_dev))):
            eng = _moe_engine(torch, cfg, p, device, flavor)
            caps = _count_captures(eng)
            waves = []
            with eng:
                for wave in range(1 + side):
                    n0 = len(caps)
                    hs = [eng.submit(list(q), max_new_tokens=MOE_NEW_ID)
                          for q in prompts]
                    for h in hs:
                        if not h.wait(600) or h._req.error is not None:
                            fail(f"moe (a) {flavor} on {device}: a stream "
                                 f"failed ({h._req.error})")
                    waves.append(([list(h._req.out_tokens) for h in hs],
                                  len(caps) - n0))
            if side == 0:
                want = waves[0][0]
            else:
                streams = waves
            del eng
        if any(w[0] != want for w in streams):
            fail(f"moe (a) {flavor}: the card's streams {streams} are not "
                 f"the CPU engine's {want}")
        if DEV == "cuda" and (streams[0][1] == 0 or streams[1][1]):
            fail(f"moe (a) {flavor}: captures {[w[1] for w in streams]} "
                 "(the first wave must capture, the warm one nothing)")
        rec[flavor] = dict(captures=[w[1] for w in streams],
                           tokens=sum(len(s) for s in want))
    ids = np.asarray([prompts[0][:9], prompts[1][:9]], np.int32)
    outs = []
    for device, p in (("cpu", p_cpu), (DEV, p_dev)):
        gen = LlamaGenerator(cfg, p, ByteTokenizer(cfg.vocab_size),
                             max_seq_len=MOE_T_ID, batch_size=2,
                             sampling=SamplingConfig(temperature=0.0,
                                                     repeat_penalty=1.0),
                             cache_dtype=torch.float32, device=device)
        outs.append(gen.generate_on_device(ids, np.asarray([9, 9]),
                                           MOE_NEW_ID).tolist())
    if outs[0] != outs[1]:
        fail(f"moe (a) generator: card {outs[1]} != CPU {outs[0]}")
    rec["generator"] = dict(tokens=2 * MOE_NEW_ID)
    rec["seconds"] = time.perf_counter() - t0
    log(f"moe (a): {len(MOE_FLAVORS)} engine flavors and the generator "
        f"equal the CPU's at f32; captures "
        f"{ {k: v['captures'] for k, v in rec.items() if k in MOE_FLAVORS} } "
        f"in {rec['seconds']:.1f} s [{card}]")
    return rec


def _moe_wave(srv, tag: str) -> dict:
    """The six MOE_CHATS at once through the HTTP API: TTFT p50, decode
    tok/s, the decode replays' device ms (single decode steps' flight
    records) and the rows' positions at those steps."""
    eng = srv.engine
    n0, tok0, dec0 = len(eng.retired), eng.stats.tokens_generated, \
        eng.stats.decode_time_s
    r0 = len(eng.flight.records())
    t_wave = time.perf_counter()
    for i, n in enumerate(MOE_CHATS):
        srv.post(f"{tag}{i}", "standard", n, MOE_NEW)
    srv.join()
    wall = time.perf_counter() - t_wave
    bad = {t: c for t, c in srv.status.items()
           if t.startswith(tag) and c[0] != 200}
    if bad:
        fail(f"moe (b) [{tag}]: chats failed {bad}")
    retired = list(eng.retired)[n0:]
    if len(retired) != 6 or any(len(r.out_tokens) != MOE_NEW
                                for r in retired):
        fail(f"moe (b) [{tag}]: expected six chats of {MOE_NEW} tokens")
    dec_s = eng.stats.decode_time_s - dec0
    recs = eng.flight.records()[r0:]
    dev = [r.device_s for r in recs
           if r.kind == "decode" and r.device_s and r.rows == 6]
    return dict(
        wall_s=wall, ttft_p50_s=statistics.median(
            r.first_token_t - r.submit_t for r in retired),
        decode_tok_s=((eng.stats.tokens_generated - tok0) / dec_s
                      if dec_s else 0.0),
        decode_replay_ms=(1e3 * statistics.median(dev) if dev else None),
        mean_prompt=statistics.mean(len(r.prompt_ids) for r in retired))


def _moe_served(torch, rpa, fa, card: str):
    """(b) Mixtral-8x7B width (D 4096, F 14336, H 32, KV 8, E 8, top 2,
    V 32000) at MOE_LAYERS of its 32 layers, random weights from a seed:
    the paged engine (8 slots, 128 x 128-token pages) behind the HTTP
    API, two warm-up waves (more, to MOE_WARM_MAX, until one captures
    nothing) then a measured one of the six chats, in each
    of MOE_DRIVES: bf16 with mixed steps, the int8 tree (--quant int8:
    experts and attention per-channel int8) over int8 pages, and bf16
    at --mixed-batch off (flash prefills). Returns (the launches summed
    over the measured waves, records)."""
    import dataclasses

    from cake_tpu_torch.models.llama.params import params_bytes
    from cake_tpu_torch.models.moe import MoEConfig
    from cake_tpu_torch.models.moe.params import (
        init_params, init_params_quantized,
    )

    cfg = dataclasses.replace(MoEConfig.mixtral_8x7b(),
                              num_hidden_layers=MOE_LAYERS,
                              use_flash_attention=True)
    L, KV, hd = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    records, launches = {}, Counter()
    for label, (tree, args_kw, needed) in MOE_DRIVES.items():
        gen = torch.Generator(device=DEV).manual_seed(7)
        init = init_params if tree == "bf16" else init_params_quantized
        params = init(cfg, gen, device=DEV, dtype=torch.bfloat16)
        weights = params_bytes(params)
        embed = params_bytes(params["embed"])
        srv = _SchedServer(torch, cfg, params, torch.bfloat16, False,
                           kv_pages=128, decode_scan=1, **args_kw)
        eng = srv.engine
        try:
            caps = _count_captures(eng)
            # warm-up waves, two and then until one captures nothing, at
            # most MOE_WARM_MAX (as spec's): the threads' arrival order
            # decides which step variants a wave meets
            for w in range(MOE_WARM_MAX):
                n_caps = len(caps)
                _moe_wave(srv, f"w{w}{label}")
                if w and len(caps) == n_caps:
                    break
            else:
                fail(f"moe (b) {label}: still capturing after "
                     f"{MOE_WARM_MAX} warm-up waves")
            warm_waves = w + 1
            if eng._mixed:
                # the mixed step's two variants here (no row emits; rows
                # emit, n_top 0): which ones a wave meets follows the
                # arrival order, so one a warm wave missed is captured
                # now, on the engine thread, as its first use would
                eng._run_on_engine_thread(lambda: [
                    eng._mixed_step_runner().captured(v) for v in (None, 0)])
            fa.reset_launch_counts()
            rpa.reset_launch_counts()
            del caps[:]
            rec = _moe_wave(srv, f"m{label}")
            got = {k: n for k, n in {**fa.LAUNCHES, **rpa.LAUNCHES}.items()
                   if n}
            # a decode step reads every block weight (all 8 experts of
            # every layer: the dense formulation) and the lm_head once,
            # 6 embedding rows, and each row's KV history (int8 pages: a
            # byte an element and an f32 scale a page and kv head)
            hist = rec["mean_prompt"] + MOE_NEW / 2
            kv = 6 * hist * L * KV * hd * 2 * 2
            if args_kw.get("kv_dtype") == "int8":
                kv = 6 * L * KV * 2 * (hist * hd + -(-hist // 128) * 4)
            bound_ms = 1e3 * (weights - embed + kv) / HBM_BYTES_PER_S
            rec.update(label=label, weights=tree,
                       kv_dtype=args_kw.get("kv_dtype") or "bf16",
                       mixed_batch=args_kw.get("mixed_batch", "auto"),
                       prefill_chunk=args_kw["prefill_chunk"],
                       captures=len(caps), warm_waves=warm_waves,
                       launches=got,
                       weight_gib=weights / 2**30,
                       decode_bound_ms=bound_ms,
                       impl=eng.flight.impl)
            if rec["captures"]:
                fail(f"moe (b) {label}: the measured wave captured "
                     f"{rec['captures']} graph(s): {caps}")
            plain = {k: n for k, n in got.items() if k.endswith("_plain")}
            if plain:
                fail(f"moe (b) {label}: plain versions ran {plain}")
            for k in needed:
                if not got.get(k):
                    fail(f"moe (b) {label}: {k} never launched")
            launches.update(got)
            records[label] = rec
            log(f"moe (b) {label}: TTFT p50 {rec['ttft_p50_s']:.3f} s, "
                f"decode {rec['decode_tok_s']:.1f} tok/s, decode replay "
                f"{rec['decode_replay_ms']} ms (bound {bound_ms:.3f} ms), "
                f"weights {rec['weight_gib']:.3f} GiB, wall "
                f"{rec['wall_s']:.2f} s, launches {got} [{card}]")
        finally:
            srv.close()
        for t in threading.enumerate():
            if t.name == "cake-http":
                t.join(timeout=60)
        gone = [weakref.ref(eng)]
        del srv, eng, params
        _release(torch, gone)
    return dict(launches), records


def phase_moe(torch, rpa, fa, card: str):
    """The moe phase: (a) the tiny MoE through every engine flavor at
    f32, (b) Mixtral-8x7B width behind the API in MOE_DRIVES. Returns
    ((b)'s measured waves' launches, record)."""
    t0 = time.perf_counter()
    _release(torch)
    held = torch.cuda.memory_allocated()
    rec = dict(identity=_moe_identity(torch, card))
    counts, rec["served"] = _moe_served(torch, rpa, fa, card)
    rec["seconds"] = time.perf_counter() - t0
    _release(torch)
    if torch.cuda.memory_allocated() > held + 2**30:
        fail("moe: the phase kept "
             f"{(torch.cuda.memory_allocated() - held) / 2**30:.2f} GiB")
    log(f"moe phase: {rec['seconds']:.1f} s")
    return counts, rec


# -- phase: sd ------------------------------------------------------------------

SD_STEPS = 20                     # (b): DDIM steps of the txt2img request
SD_GUIDANCE = 7.5                 # (b): guidance on: the UNet's batch is 2
SD_IMG2IMG_STEPS = 4              # (b): the CLI's img2img
SD_TINY_STEPS = 3                 # (a)
SD_REL_TOL = 1e-4                 # (a): the replayed step against eager, f32


def unet_flops(u, B: int, h: int, w: int, S: int) -> float:
    """FLOPs (2 x multiply-adds) of one UNet forward of the config `u`
    at latents h x w, batch B, a context of S tokens: its convolutions,
    linears and attention products (QK^T and PV), the walk of
    unet_forward; norms and pointwise ops left out."""
    ch = u.block_out_channels
    temb = ch[0] * u.time_embed_dim_mult
    ctx = u.cross_attention_dim

    def conv(H, W, k, cin, cout):
        return 2 * B * H * W * k * k * cin * cout

    def lin(n, cin, cout):
        return 2 * B * n * cin * cout

    def res(H, W, cin, cout):
        f = conv(H, W, 3, cin, cout) + conv(H, W, 3, cout, cout) \
            + lin(1, temb, cout)
        return f + (conv(H, W, 1, cin, cout) if cin != cout else 0)

    def xf(H, W, c, layers):
        N = H * W
        f = 2 * lin(N, c, c)                             # proj_in, proj_out
        for _ in range(layers):
            f += 4 * lin(N, c, c) + 4 * B * N * N * c      # self attention
            f += 2 * lin(N, c, c) + 2 * lin(S, ctx, c) \
                + 4 * B * N * S * c                        # cross attention
            f += lin(N, c, 8 * c) + lin(N, 4 * c, c)       # GEGLU
        return f

    f = lin(1, ch[0], temb) + lin(1, temb, temb)
    if u.addition_embed_dim:
        f += lin(1, u.addition_embed_dim, temb) + lin(1, temb, temb)
    f += conv(h, w, 3, u.in_channels, ch[0])
    H, W = h, w
    skips = [ch[0]]
    for i, cout in enumerate(ch):
        cin = ch[i - 1] if i else ch[0]
        for j in range(u.layers_per_block):
            f += res(H, W, cin if j == 0 else cout, cout)
            if u.attn_blocks[i]:
                f += xf(H, W, cout, u.transformer_layers_per_block[i])
            skips.append(cout)
        if i < len(ch) - 1:
            H, W = H // 2, W // 2
            f += conv(H, W, 3, cout, cout)
            skips.append(cout)
    mid = u.transformer_layers_per_block[-1] if u.attn_blocks[-1] else 1
    f += 2 * res(H, W, ch[-1], ch[-1]) + xf(H, W, ch[-1], mid)
    prev = ch[-1]
    for i, cout in enumerate(reversed(ch)):
        src = len(ch) - 1 - i
        for j in range(u.layers_per_block + 1):
            f += res(H, W, prev + skips.pop(), cout)
            prev = cout
            if u.attn_blocks[src]:
                f += xf(H, W, cout, u.transformer_layers_per_block[src])
        if i < len(ch) - 1:
            H, W = H * 2, W * 2
            f += conv(H, W, 3, cout, cout)
    return float(f + conv(h, w, 3, ch[0], u.out_channels))


def _sd_tiny(torch, card: str) -> dict:
    """(a) tiny_sd_config at f32, the trees drawn on the host from a
    seed: the card generator's u8 images within one level of the CPU
    generator's for one seed (the noise drawn on the host for both, so
    both denoise the same latents), and the captured UNet step against
    its eager call, guidance on and off."""
    import numpy as np

    from cake_tpu_torch.args import ImageGenerationArgs
    from cake_tpu_torch.models.sd.clip import init_clip_params
    from cake_tpu_torch.models.sd.config import tiny_sd_config
    from cake_tpu_torch.models.sd.image import decode_png
    from cake_tpu_torch.models.sd.sd import (
        SDGenerator, SimpleClipTokenizer, unet_step,
    )
    from cake_tpu_torch.models.sd.unet import init_unet_params
    from cake_tpu_torch.models.sd.vae import init_vae_params

    t0 = time.perf_counter()
    cfg = tiny_sd_config()
    g = torch.Generator().manual_seed(0)
    tree = {"clip": init_clip_params(cfg.clip, g),
            "unet": init_unet_params(cfg.unet, g),
            "vae": init_vae_params(cfg.vae, g)}

    def moved(t, device):
        if isinstance(t, dict):
            return {k: moved(v, device) for k, v in t.items()}
        if isinstance(t, list):
            return [moved(v, device) for v in t]
        return t.to(device)

    images, gens = {}, {}
    for device in ("cpu", DEV):
        gen = SDGenerator(cfg, moved(tree, device),
                          [SimpleClipTokenizer(cfg.clip.vocab_size)],
                          torch.float32, device=device)
        host = torch.Generator().manual_seed(5)
        gen._noise = (lambda shape, _g, gen=gen, host=host: torch.randn(
            shape, generator=host).to(gen.device, gen.dtype))
        out = []
        gen.generate_image(ImageGenerationArgs(
            image_prompt="a red barn", sd_n_steps=SD_TINY_STEPS,
            sd_seed=1), out.extend)
        images[device] = [decode_png(p) for p in out]
        gens[device] = gen
    diff = max(int(np.abs(a.astype(int) - b.astype(int)).max())
               for a, b in zip(images["cpu"], images[DEV]))
    if diff > 1:
        fail(f"sd (a): the card's image is {diff} levels from the CPU's")
    gen = gens[DEV]
    caps = _count_captures(gen)
    errs = []
    gd = torch.Generator(device=DEV).manual_seed(2)
    side = cfg.height // cfg.vae.downscale_factor
    for scale, on in ((7.5, True), (3.0, True), (1.0, False)):
        lat = torch.randn(1, side, side, 4, generator=gd, device=DEV)
        ctx = torch.randn(2 if on else 1, 77, 64, generator=gd, device=DEV)
        for t in (951.0, 11.0):
            got = gen.unet_runner.run(lat, t, ctx, None, scale, on).clone()
            want = unet_step(gen.params["unet"], cfg.unet, lat,
                             torch.tensor([t], device=DEV), ctx, None,
                             scale, on)
            err = float((got - want).abs().max() / want.abs().max())
            errs.append(err)
            if err > SD_REL_TOL:
                fail(f"sd (a): the replayed UNet step is {err:.2e} of its "
                     "scale from its eager call")
    if DEV == "cuda" and caps != ["_make_unet_step"]:
        fail(f"sd (a): captures {caps}, expected the guidance-off "
             "variant's one (the guidance-on one came with the images)")
    rec = dict(levels=diff, step_rel_err=max(errs),
               seconds=time.perf_counter() - t0)
    log(f"sd (a): tiny f32 images within {diff} level(s) of the CPU's; "
        f"the replayed step within {max(errs):.2e} of its eager call "
        f"({rec['seconds']:.1f} s) [{card}]")
    return rec


def _sd_step_times(torch, gen, card: str) -> dict:
    """The UNet step of `gen` as its generations run it (B = 1 at the
    config's latents; guidance on, batch 2, when the preset's default
    asks for it): the replay's device ms (CUDA events around 10 replays,
    the inputs' copies into the graph's buffers included) beside the
    eager call's host ms and the bound (the counted FLOPs at the bf16
    peak, or the UNet's weight bytes at the memory rate)."""
    from cake_tpu_torch.models.llama.params import params_bytes
    from cake_tpu_torch.models.sd.sd import unet_step

    cfg = gen.config
    f = cfg.vae.downscale_factor
    h, w = cfg.height // f, cfg.width // f
    scale = cfg.default_guidance
    on = scale > 1.0
    ctx, added = gen.text_embeddings("a red barn", "", on)
    gd = torch.Generator(device=DEV).manual_seed(3)
    lat = torch.randn(1, h, w, cfg.vae.latent_channels, generator=gd,
                      device=DEV, dtype=gen.dtype)
    run = lambda: gen.unet_runner.run(lat, 500.0, ctx, added,  # noqa: E731
                                      scale, on)
    run()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(10):
        run()
    b.record()
    b.synchronize()
    replay_ms = a.elapsed_time(b) / 10
    t = torch.tensor([500.0], device=DEV)
    with torch.inference_mode():
        unet_step(gen.params["unet"], cfg.unet, lat, t, ctx, added, scale,
                  on)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            unet_step(gen.params["unet"], cfg.unet, lat, t, ctx, added,
                      scale, on)
        torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / 3
    B = 2 if on else 1
    flops = unet_flops(cfg.unet, B, h, w, 77)
    nbytes = params_bytes(gen.params["unet"])
    bound = max(1e3 * flops / PEAK_OPS["bfloat16"],
                1e3 * nbytes / HBM_BYTES_PER_S)
    rec = dict(replay_ms=replay_ms, eager_host_ms=eager_ms, bound_ms=bound,
               bound_by=("operations" if flops / PEAK_OPS["bfloat16"]
                         > nbytes / HBM_BYTES_PER_S else "bytes"),
               tflop=flops / 1e12, unet_gib=nbytes / 2**30,
               latents=[B, h, w])
    log(f"sd UNet step {cfg.version.value} at {B} x {h} x {w}: replay "
        f"{replay_ms:.3f} ms device, eager {eager_ms:.3f} ms host, bound "
        f"{bound:.3f} ms ({rec['tflop']:.3f} TFLOP at the bf16 peak; "
        f"{rec['unet_gib']:.3f} GiB of weights) [{card}]")
    return rec


def _sd_v15(torch, card: str, tree: str) -> dict:
    """(b) v1-5 at full width, 512 x 512, bf16, random weights (no
    checkpoint resolves): txt2img through POST /api/v1/image (SD_STEPS
    DDIM steps at guidance 7.5), the graph pool's peak over the first
    capture, the UNet step's replay beside its eager call and its bound,
    then img2img through the CLI in a child process over the PNG the
    API returned."""
    import base64
    import tempfile

    from cake_tpu_torch.api.server import start
    from cake_tpu_torch.args import Args, ModelType, SDArgs
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.sd.image import decode_png

    t0 = time.perf_counter()
    master = Master.from_args(
        Args(model_type=ModelType.IMAGE, cpu=DEV == "cpu"),
        SDArgs(sd_version="v1-5"))
    gen = master.image
    caps = _count_captures(gen)
    httpd = start(master, "127.0.0.1:0", block=False)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    rec = dict(load_s=time.perf_counter() - t0)
    try:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        code, out = _http_json(url + "/api/v1/image", {
            "image_prompt": "a red barn in a snowy field",
            "sd_n_steps": SD_STEPS, "sd_guidance_scale": SD_GUIDANCE,
            "sd_seed": 1})
        rec["txt2img_s"] = time.perf_counter() - t1
        rec["pool_peak_gib"] = (torch.cuda.max_memory_allocated()
                                - before) / 2**30
        if code != 200 or len(out.get("images", ())) != 1:
            fail(f"sd (b): /api/v1/image got {code} {str(out)[:200]}")
        png = base64.b64decode(out["images"][0])
        img = decode_png(png)
        if img.shape != (512, 512, 3) or img.std() == 0:
            fail(f"sd (b): the image is {img.shape}, std {img.std()}")
        if caps != ["_make_unet_step"]:
            fail(f"sd (b): captures {caps}, expected one UNet step")
    finally:
        httpd.shutdown()
        httpd.server_close()
    rec["step"] = _sd_step_times(torch, gen, card)
    del master, gen, httpd
    _release(torch)
    tmp = tempfile.mkdtemp(prefix="cake-sd-")
    src = os.path.join(tmp, "txt2img.png")
    with open(src, "wb") as f:
        f.write(png)
    t1 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=tree)
    p = subprocess.run(
        [sys.executable, "-m", "cake_tpu_torch.cli", "--model-type",
         "image", "--sd-img2img", src, "--sd-img2img-strength", "0.8",
         "--sd-n-steps", str(SD_IMG2IMG_STEPS)]
        + (["--cpu"] if DEV == "cpu" else []), cwd=tmp, env=env,
        capture_output=True, text=True, timeout=300)
    rec["img2img_cli_s"] = time.perf_counter() - t1
    out_png = os.path.join(tmp, "image_0.png")
    if p.returncode != 0 or not os.path.exists(out_png):
        fail(f"sd (b): the CLI's img2img exited {p.returncode}: "
             f"{p.stderr[-2000:]}")
    with open(out_png, "rb") as f:
        got = decode_png(f.read())
    if got.shape != (512, 512, 3):
        fail(f"sd (b): the CLI's image_0.png is {got.shape}")
    log(f"sd (b) v1-5 512 x 512 bf16: txt2img {SD_STEPS} steps through "
        f"the API in {rec['txt2img_s']:.2f} s (load {rec['load_s']:.1f} s, "
        f"pool peak {rec['pool_peak_gib']:.3f} GiB over the first capture "
        f"and generation); the CLI's img2img ({SD_IMG2IMG_STEPS} steps at "
        f"0.8) wrote image_0.png in {rec['img2img_cli_s']:.1f} s of child "
        f"process [{card}]")
    return rec


def _sd_turbo(torch, card: str) -> dict:
    """(c) turbo (SDXL width: two encoders, Euler, the added condition)
    at 512 x 512, bf16, random weights: one step, no guidance."""
    from cake_tpu_torch.args import Args, ImageGenerationArgs, ModelType
    from cake_tpu_torch.args import SDArgs
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.sd.image import decode_png

    t0 = time.perf_counter()
    master = Master.from_args(
        Args(model_type=ModelType.IMAGE, cpu=DEV == "cpu"),
        SDArgs(sd_version="turbo", sd_height=512, sd_width=512))
    gen = master.image
    if gen.config.clip2 is None or not gen.config.unet.addition_embed_dim:
        fail("sd (c): turbo loaded without its second encoder")
    out = []
    t1 = time.perf_counter()
    master.generate_image(ImageGenerationArgs(image_prompt="a cat",
                                              sd_seed=3), out.extend)
    gen_s = time.perf_counter() - t1
    img = decode_png(out[0]) if len(out) == 1 else None
    if img is None or img.shape != (512, 512, 3):
        fail(f"sd (c): turbo gave {len(out)} image(s), the first "
             f"{None if img is None else img.shape}")
    rec = dict(generate_s=gen_s, seconds=time.perf_counter() - t0,
               steps=gen.config.default_steps)
    rec["step"] = _sd_step_times(torch, gen, card)
    log(f"sd (c) turbo 512 x 512 bf16: one Euler step, no guidance, in "
        f"{gen_s:.2f} s with the capture ({rec['seconds']:.1f} s with the "
        f"load) [{card}]")
    del master, gen
    _release(torch)
    return rec


def phase_sd(torch, card: str, tree: str) -> dict:
    """The sd phase: (a) tiny at f32 against the CPU, (b) v1-5 at 512 x
    512 through the API and the CLI, (c) turbo at SDXL width."""
    t0 = time.perf_counter()
    _release(torch)
    rec = dict(tiny=_sd_tiny(torch, card))
    _release(torch)
    rec["v1_5"] = _sd_v15(torch, card, tree)
    rec["turbo"] = _sd_turbo(torch, card)
    rec["seconds"] = time.perf_counter() - t0
    log(f"sd phase: {rec['seconds']:.1f} s")
    return rec


# -- phase: parallel ------------------------------------------------------------

PAR_LAYERS = 8                    # (a): Llama-3-8B width, 8 of its 32 blocks
PAR_TOPOLOGY = ("a:\n  layers:\n    - model.layers.0-3\n"
                "b:\n  layers:\n    - model.layers.4-7\n")
PAR_T = 1024                      # (a): max_seq_len
PAR_CHUNK = 256                   # (a): --prefill-chunk
PAR_CHATS = (160, 300, 180, 200, 600, 250, 170, 400)  # (a): prompt tokens
PAR_NEW = 16                      # (a): tokens a chat
PAR_BF16_TOL = 5e-2               # (a) bf16: logits, share of max |logits|
PAR_GEN_LAYERS = 4                # (b): blocks of the generator drives
PAR_GEN_NEW = 8                   # (b): tokens a row
PAR_MOE_LAYERS = 2                # (c): Mixtral-8x7B's blocks kept
PAR_SD_STEPS = 4                  # (c): SD v1-5 --dp 2 DDIM steps
PAR_SD_LEVELS = 1                 # (c): u8 levels a dp image may differ
# (c) bf16: the --dp 2 image's mean u8 distance from the f32 image, as a
# multiple of the unsharded bf16 image's (1.016 on an H100: 3.368 and
# 3.315 levels)
PAR_SD_BF16_RATIO = 1.25


def _par_args(**kw):
    from cake_tpu_torch.args import Args
    base = dict(max_seq_len=PAR_T, temperature=0.0, repeat_penalty=1.0,
                sample_len=PAR_NEW, max_slots=8, decode_scan=1,
                prefill_chunk=PAR_CHUNK, dtype="f32", cpu=DEV == "cpu")
    base.update(kw)
    return Args(**base).validate()


def _par_topology(text: str = PAR_TOPOLOGY) -> str:
    import tempfile
    path = os.path.join(tempfile.mkdtemp(prefix="cake-topo-"), "t.yml")
    with open(path, "w") as f:
        f.write(text)
    return path


def _par_generator(torch, cfg, params, args, mesh_devices=None):
    """The generator Context.load_text_model builds for `args` (its
    plan's mesh on `mesh_devices`), over `params` (a tree made here, not
    loaded): the sharded path's placement and forward, or the plain
    generator."""
    from cake_tpu_torch.context import Context
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.parallel.plan import ParallelPlan

    ctx = Context.from_args(args, mesh_devices=mesh_devices)
    plan = ParallelPlan.from_topology(cfg, ctx.topology, args=args,
                                      num_devices=ctx._device_count())
    kw = {}
    if plan.sharded:
        ctx._check_plan(cfg, plan)
        kw = ctx._place(cfg, plan, params, args.max_seq_len, ctx.dtype)
        params = kw.pop("params")
    return LlamaGenerator(cfg, params, ByteTokenizer(cfg.vocab_size),
                          max_seq_len=args.max_seq_len,
                          batch_size=args.batch_size,
                          sampling=SamplingConfig(temperature=0.0,
                                                  repeat_penalty=1.0),
                          cache_dtype=ctx.dtype, device=ctx.device, **kw)


def _par_wave(srv, tag: str, chats=PAR_CHATS, n_new: int = PAR_NEW,
              what: str = "parallel (a)") -> dict:
    """`chats` chats at once through the HTTP API (each of that many
    prompt tokens), n_new tokens each: TTFT p50, decode tok/s, a decode
    replay's device ms (a K-step burst's device time over its K
    replays), the bursts run, the streams."""
    eng = srv.engine
    n0, tok0, dec0 = len(eng.retired), eng.stats.tokens_generated, \
        eng.stats.decode_time_s
    r0 = len(eng.flight.records())
    t_wave = time.perf_counter()
    tags = [f"{tag}{i}" for i in range(len(chats))]
    for t, n in zip(tags, chats):
        srv.post(t, "standard", n, n_new)
    srv.join()
    wall = time.perf_counter() - t_wave
    bad = {t: srv.status.get(t) for t in tags
           if srv.status.get(t, (0,))[0] != 200}
    if bad:
        fail(f"{what} [{tag}]: chats failed {bad}")
    retired = sorted(list(eng.retired)[n0:], key=lambda r: r.prompt_ids)
    if len(retired) != len(chats):
        fail(f"{what} [{tag}]: {len(retired)} chats retired")
    dec_s = eng.stats.decode_time_s - dec0
    recs = eng.flight.records()[r0:]
    dev = [r.device_s for r in recs if r.kind == "decode" and r.device_s]
    dev += [r.device_s / eng._decode_scan for r in recs
            if r.kind == "decode_scan" and r.device_s]
    return dict(
        wall_s=wall, ttft_p50_s=statistics.median(
            r.first_token_t - r.submit_t for r in retired),
        decode_tok_s=((eng.stats.tokens_generated - tok0) / dec_s
                      if dec_s else 0.0),
        decode_replay_ms=(1e3 * statistics.median(dev) if dev else None),
        bursts=sum(r.kind == "decode_scan" for r in recs),
        streams=[list(r.out_tokens) for r in retired])


class _ParServer(_SchedServer):
    """_SchedServer over a generator built here (sharded or not)."""

    def __init__(self, torch, gen, args):
        from cake_tpu_torch.api.server import start
        from cake_tpu_torch.master import Master
        self.gen = gen
        self.master = Master(args, text_generator=gen)
        self.engine = self.master.make_engine()
        self.httpd = start(self.master, "127.0.0.1:0", block=False,
                           engine=self.engine)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.threads, self.status, self._reqs = [], {}, {}


def _par_served(torch, fa, cfg, params, card: str):
    """(a) the unsharded dense engine, then the engine over a two-stage
    topology with --tp 2 --microbatches 2 on four mesh positions of the
    card, behind the HTTP API at f32: a warm-up wave, then a measured one
    (the counts set to 0 just before it) whose streams must be the
    unsharded engine's, whose flash launches (whole prompts and chunk
    windows) come from the sharded steps and which captures nothing."""
    rec, counts, ref = {}, {}, None
    topo = _par_topology()
    for label in ("unsharded", "sharded"):
        sharded = label == "sharded"
        # the generator's batch must divide into the microbatches too
        args = _par_args(**(dict(topology=topo, tp=2, microbatches=2,
                                 batch_size=2) if sharded else {}))
        gen = _par_generator(torch, cfg, params, args,
                             mesh_devices=[DEV] * 4 if sharded else None)
        srv = _ParServer(torch, gen, args)
        eng = srv.engine
        try:
            if sharded != eng._custom_steps:
                fail(f"parallel (a): make_engine built custom steps "
                     f"{eng._custom_steps} for the {label} generator")
            caps = _count_captures(eng)
            _par_wave(srv, "w")
            fa.reset_launch_counts()
            del caps[:]
            r = _par_wave(srv, "m")
            r.update(captures=len(caps), launches={
                k: n for k, n in fa.LAUNCHES.items() if n},
                cache_gib=eng.cache.memory_bytes() / 2**30)
            if r["captures"]:
                fail(f"parallel (a) {label}: the measured wave captured "
                     f"{r['captures']} graph(s)")
            for k in ("flash_attn", "flash_attn_cached"):
                if r["launches"].get(k, 0) <= 0:
                    fail(f"parallel (a) {label}: {k} never launched")
            plain = {k: n for k, n in r["launches"].items()
                     if k.endswith("_plain")}
            if plain:
                fail(f"parallel (a) {label}: plain versions ran {plain}")
            if sharded:
                counts = dict(r["launches"])
                if eng._runner is None or not eng._runner.captures:
                    fail("parallel (a): no captured pipelined decode step")
            log(f"parallel (a) {label:<9}: TTFT p50 {r['ttft_p50_s']:.3f} s, "
                f"decode {r['decode_tok_s']:.1f} tok/s, decode replay "
                f"{r['decode_replay_ms']} ms, wall {r['wall_s']:.2f} s, "
                f"cache {r['cache_gib']:.3f} GiB, launches {r['launches']} "
                f"[{card}]")
        finally:
            srv.close()
        for t in threading.enumerate():
            if t.name == "cake-http":
                t.join(timeout=60)
        gone = [weakref.ref(eng)]
        del srv, eng, gen
        _release(torch, gone)
        if ref is None:
            ref = r["streams"]
        elif r["streams"] != ref:
            same = sum(a == b for a, b in zip(r["streams"], ref))
            fail(f"parallel (a): {same} of {len(ref)} f32 streams equal the "
                 "unsharded engine's")
        r.pop("streams")
        rec[label] = r
    return counts, rec


def _par_bf16(torch, cfg, card: str) -> dict:
    """(a) at bf16: one whole-prompt prefill and one decode step through
    the pipelined engine steps (tp 2, two stages) against the unsharded
    model's, logits within PAR_BF16_TOL of their largest magnitude (the
    tp reduce sums in another order; bf16 rounds apart)."""
    from cake_tpu_torch.models.llama import model as tm
    from cake_tpu_torch.models.llama.cache import KVCache
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.parallel.mesh import make_mesh
    from cake_tpu_torch.parallel.pipeline import (
        make_engine_step_fns, place_params,
    )
    from cake_tpu_torch.parallel.sharding import create_sharded_cache

    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(3),
                         device=DEV, dtype=torch.bfloat16)
    mesh = make_mesh(1, 2, 2, devices=[DEV] * 4)
    sp = place_params(params, mesh, tp=True)
    fns = make_engine_step_fns(mesh, cfg, num_microbatches=2, tp=True)
    rope = tm.RopeTables.create(cfg, PAR_T, device=DEV)
    B, S, n = 4, 256, 200
    gen = torch.Generator(device=DEV).manual_seed(4)
    ids = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                        device=DEV, dtype=torch.int32)
    plen = torch.tensor([n], dtype=torch.int32, device=DEV)
    dense = KVCache.create(cfg, B, PAR_T, dtype=torch.bfloat16, device=DEV)
    sh = create_sharded_cache(cfg, B, PAR_T, mesh, tp_axis="tp",
                              dtype=torch.bfloat16)
    out = {}
    with torch.inference_mode():
        want, _ = tm.prefill_slot(params, ids, plen, 1, dense, rope, cfg)
        got, _ = fns[0](sp, ids, plen, 1, sh, rope, cfg)
        tok = torch.full((B, 1), 7, dtype=torch.int32, device=DEV)
        pos = torch.tensor([0, n, 0, 0], dtype=torch.int32, device=DEV)
        live = torch.tensor([False, True, False, False], device=DEV)
        want2, _ = tm.decode_step_ragged(params, tok, pos, live, dense,
                                         rope, cfg)
        got2, _ = fns[1](sp, tok, pos, live, sh, rope, cfg)
    for name, w, g in (("prefill", want, got), ("decode", want2[1], got2[1])):
        share = ((w - g).abs().max() / w.abs().max()).item()
        out[name] = share
        if not share <= PAR_BF16_TOL:
            fail(f"parallel (a) bf16 {name}: logits differ by {share:.4f} "
                 f"of max |logits| (> {PAR_BF16_TOL})")
    log(f"parallel (a) bf16: prefill and decode logits within "
        f"{out['prefill']:.4f} and {out['decode']:.4f} of max |logits| "
        f"(tol {PAR_BF16_TOL}) [{card}]")
    del params, sp, dense, sh
    return out


def _par_kernels(torch, fa, i4, card: str) -> dict:
    """Rows 7, 8 and 9 at the shard shapes the sharded steps launch them
    at, against their plain versions: flash_attn over a tp rank's 16
    query and 4 kv heads (a 512-token prompt), flash_attn_cached over a
    256-token window at pos 256 of that rank's cache, both at f32 (the
    scalar bodies (a)'s f32 drive launches) and at bf16 (the tensor-core
    bodies), each within TOL of its dtype; int4_matmul over a tp 2
    rank's wq [4096 -> 2048], wo [2048 -> 4096] (16 groups) and w_down
    [7168 -> 4096] (56 groups) at one row, with its cluster plan (at
    most 16 ranks)."""
    from cake_tpu_torch.ops.quant import quantize_group

    gen = torch.Generator(device=DEV).manual_seed(5)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=DEV, dtype=dtype)

    rec = {}
    pos = torch.tensor([256], dtype=torch.int32, device=DEV)
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        q, k, v = (rnd(1, 512, 16, 128, dtype=dt), rnd(1, 512, 4, 128, dtype=dt),
                   rnd(1, 512, 4, 128, dtype=dt))
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        errs = dict(flash_attn=(got.float() - want.float()).abs().max().item())
        kc, vc = rnd(1, PAR_T, 4, 128, dtype=dt), rnd(1, PAR_T, 4, 128, dtype=dt)
        qw = rnd(1, 256, 16, 128, dtype=dt)
        got = fa.flash_attention_cached(qw, kc, vc, pos)
        want = fa.flash_attention_cached_plain(qw, kc, vc, pos)
        errs["flash_attn_cached"] = (got.float()
                                     - want.float()).abs().max().item()
        for name, err in errs.items():
            rec[f"{name}_{dname}"] = err
            if not err <= TOL[dname]["atol"]:
                fail(f"parallel: {name} at the tp shard's heads, {dname}, "
                     f"differs from its plain version by {err} (tol "
                     f"{TOL[dname]['atol']})")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (In, Out) in (("wq", (4096, 2048)), ("wo", (2048, 4096)),
                            ("w_down", (7168, 4096))):
        w = quantize_group(rnd(In, Out, dtype=torch.float32), 0)
        g = 2 * w.q.shape[0] // w.scale.shape[0]
        x = rnd(1, In)
        got = i4.int4_matmul(x, w.q, w.scale, g=g)
        want = i4.int4_matmul_plain(x, w.q, w.scale, g=g)
        err = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        ranks = i4.split_plan(1, In // g, Out,
                              i4.takes_tc(1, g, torch.bfloat16), n_sm)
        rec[f"int4_{name}"] = dict(groups=In // g, cluster=ranks, err=err)
        if not (err <= TOL["bfloat16"]["rtol"] and 1 <= ranks <= 16):
            fail(f"parallel: int4_matmul over the tp shard of {name} "
                 f"[{In} -> {Out}]: share {err}, cluster {ranks}")
    log(f"parallel kernels at shard shapes: {rec} [{card}]")
    return rec


def _par_generators(torch, i4, card: str) -> dict:
    """(b) the generator through Context.load_text_model (random f32
    weights from seed 0, PAR_GEN_LAYERS blocks at 8B width): over a
    two-stage topology with --dp 2 at --batch-size 4, greedy-identical to
    the unsharded generator (next_token and generate_on_device); then
    --quant int4 over two stages x --tp 2 at bf16: its int4_matmul
    launches (counted from 0 before it) and no plain one, its logits
    within PAR_BF16_TOL of the unsharded int4 generator's."""
    import dataclasses

    import numpy as np

    from cake_tpu_torch.context import Context
    from cake_tpu_torch.models.chat import Message
    from cake_tpu_torch.models.llama.config import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=PAR_GEN_LAYERS,
                              use_flash_attention=True)
    topo = _par_topology("a:\n  layers:\n    - model.layers.0-1\n"
                         "b:\n  layers:\n    - model.layers.2-3\n")
    rec, outs = {}, {}
    prompt = np.full((4, 24), 9, np.int32)
    prompt[:, ::3] = 77
    for label, kw in (("single", {}), ("stage2_dp2", dict(topology=topo,
                                                          dp=2))):
        args = _par_args(batch_size=4, prefill_chunk=None, **kw)
        ctx = Context.from_args(args, mesh_devices=[DEV] * 4 if kw else None)
        ctx.llama_config = cfg
        g = ctx.load_text_model()
        g.add_message(Message.user("the same prompt on every row"))
        toks = [g.next_token(i).id for i in range(PAR_GEN_NEW)]
        god = g.generate_on_device(prompt, np.full((4,), 24, np.int32),
                                   PAR_GEN_NEW)
        outs[label] = (toks, god.tolist())
        del g, ctx
        _release(torch)
    if outs["single"] != outs["stage2_dp2"]:
        fail(f"parallel (b): stage 2 x dp 2 gave {outs['stage2_dp2']}, the "
             f"unsharded generator {outs['single']}")
    rec["dp_identity"] = True
    logits = {}
    for label, kw in (("single", {}), ("stage2_tp2", dict(topology=topo,
                                                          tp=2))):
        args = _par_args(batch_size=1, prefill_chunk=None, quant="int4",
                         dtype="bf16", **kw)
        ctx = Context.from_args(args, mesh_devices=[DEV] * 4 if kw else None)
        ctx.llama_config = cfg
        g = ctx.load_text_model()
        g.add_message(Message.user("int4 over a topology"))
        g.next_token(0)
        i4.reset_launch_counts()
        for i in range(1, 4):
            g.next_token(i)
        torch.cuda.synchronize()
        logits[label] = g._decode.logits[0].float().clone()
        if kw:
            rec["int4_launches"] = dict(i4.LAUNCHES)
        del g, ctx
        _release(torch)
    n = rec["int4_launches"]
    if n["int4_matmul"] <= 0 or n["int4_matmul_plain"]:
        fail(f"parallel (b): int4 launches {n}")
    share = ((logits["single"] - logits["stage2_tp2"]).abs().max()
             / logits["single"].abs().max()).item()
    rec["int4_logits_share"] = share
    if not share <= PAR_BF16_TOL:
        fail(f"parallel (b): int4 stage 2 x tp 2 logits differ by {share}")
    log(f"parallel (b): stage 2 x dp 2 greedy-identical; int4 stage 2 x "
        f"tp 2: {n} launches, logits within {share:.4f} [{card}]")
    return rec


def _par_moe_sd(torch, card: str, tree: str) -> dict:
    """(c) Mixtral-8x7B width, PAR_MOE_LAYERS blocks, f32: the pipelined
    forward over one stage x tp 2 (the experts' ffn dim split) greedy
    -identical to the unsharded generator; then SD v1-5 512 x 512 at f32
    through Context with --dp 2 (the UNet's guidance pair over two mesh
    positions of the card) against the same generator unsharded, one seed,
    u8 images within PAR_SD_LEVELS. At bf16, over the same weights
    rounded: the mesh's UNet call equals two batch-1 calls with no mesh
    (`_sd_split_witness`), and the --dp 2 image's mean distance from the
    f32 image is at most PAR_SD_BF16_RATIO times the unsharded bf16
    image's (random weights and guidance 7.5 amplify bf16 rounding, so
    the two bf16 images are not held to each other)."""
    import dataclasses

    import numpy as np

    from cake_tpu_torch.args import Args, ImageGenerationArgs, ModelType, \
        SDArgs
    from cake_tpu_torch.context import Context
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.models.moe import MoEConfig
    from cake_tpu_torch.models.moe.params import init_params as moe_init
    from cake_tpu_torch.models.sd.image import decode_png
    from cake_tpu_torch.models.sd.sd import SDGenerator
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.parallel.mesh import make_mesh

    rec = {}
    cfg = dataclasses.replace(MoEConfig.mixtral_8x7b(),
                              num_hidden_layers=PAR_MOE_LAYERS,
                              use_flash_attention=True)
    params = moe_init(cfg, torch.Generator(device=DEV).manual_seed(6),
                      device=DEV, dtype=torch.float32)
    prompt = np.full((1, 40), 11, np.int32)
    outs = {}
    for label, kw in (("single", {}), ("tp2", dict(tp=2))):
        args = _par_args(batch_size=1, prefill_chunk=None, max_seq_len=256,
                         **kw)
        g = _par_generator(torch, cfg, params, args,
                           mesh_devices=[DEV] * 2 if kw else None)
        outs[label] = g.generate_on_device(
            prompt, np.full((1,), 40, np.int32), PAR_GEN_NEW).tolist()
        del g
        _release(torch)
    del params
    _release(torch)
    if outs["single"] != outs["tp2"]:
        fail(f"parallel (c): MoE tp 2 gave {outs['tp2']}, unsharded "
             f"{outs['single']}")
    rec["moe_identity"] = outs["tp2"][0]
    ctx = Context.from_args(Args(model_type=ModelType.IMAGE,
                                 cpu=DEV == "cpu"),
                            SDArgs(sd_version="v1-5", sd_use_f16=False))
    f32 = ctx.load_image_model()
    # the bf16 generator (sd_use_f16's dtype) over the same weights rounded
    bf16 = SDGenerator(f32.config, _cast_tree(f32.params, torch.bfloat16),
                       f32.tokenizers, dtype=torch.bfloat16, device=DEV)
    for dname, g in (("f32", f32), ("bf16", bf16)):
        rec[f"sd_split_{dname}"] = _sd_split_witness(torch, g)
    imgs = {}
    for dname, g in (("f32", f32), ("bf16", bf16)):
        for label in ("single", "dp2"):
            if label == "dp2":
                g.shard_for_mesh(make_mesh(dp=2, devices=[DEV] * 2))
            got = []
            t0 = time.perf_counter()
            g.generate_image(ImageGenerationArgs(
                image_prompt="a red barn", sd_n_steps=PAR_SD_STEPS,
                sd_guidance_scale=7.5, sd_seed=3),
                lambda pngs: got.extend(decode_png(p) for p in pngs))
            rec[f"sd_{dname}_{label}_s"] = time.perf_counter() - t0
            imgs[f"{dname}_{label}"] = got[-1].astype(int)
    del f32, bf16, ctx
    _release(torch)

    def dist(a, b):
        d = np.abs(imgs[a] - imgs[b])
        return dict(max=int(d.max()), mean=float(d.mean()),
                    equal=float((d == 0).mean()))

    pairs = rec["sd_images"] = {
        "f32 dp2 / f32": dist("f32_dp2", "f32_single"),
        "bf16 / f32": dist("bf16_single", "f32_single"),
        "bf16 dp2 / f32": dist("bf16_dp2", "f32_single"),
        "bf16 dp2 / bf16": dist("bf16_dp2", "bf16_single")}
    diff = pairs["f32 dp2 / f32"]["max"]
    if diff > PAR_SD_LEVELS or imgs["f32_single"].std() == 0:
        fail(f"parallel (c): SD --dp 2's f32 image differs by {diff} levels")
    near, far = pairs["bf16 / f32"]["mean"], pairs["bf16 dp2 / f32"]["mean"]
    if not far <= PAR_SD_BF16_RATIO * near or imgs["bf16_dp2"].std() == 0:
        fail(f"parallel (c): SD --dp 2's bf16 image is {far:.3f} levels from "
             f"the f32 image on average, the unsharded bf16 one {near:.3f} "
             f"(ratio > {PAR_SD_BF16_RATIO})")
    log(f"parallel (c): MoE tp 2 greedy-identical; SD --dp 2 at f32 within "
        f"{diff} level(s); UNet batch split {rec['sd_split_f32']} at f32, "
        f"{rec['sd_split_bf16']} at bf16; images {pairs} [{card}]")
    return rec


def _cast_tree(tree, dtype):
    """A param tree (dicts, lists, tensors) with its float leaves cast."""
    import torch
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _sd_split_witness(torch, g) -> dict:
    """One UNet call over a guidance pair (random latents at t 999, the
    pair's text context) three ways, eagerly: batch 2 with no mesh, two
    batch-1 calls with no mesh, and the --dp 2 mesh's split (`_unet_dp`
    over two replicas on the card). The mesh's split must equal the two
    batch-1 calls exactly; the batch split's own distance from batch 2
    (share of max |eps|) is recorded."""
    from cake_tpu_torch.models.sd.sd import _unet_dp
    from cake_tpu_torch.models.sd.unet import unet_forward

    cfg, p = g.config, g.params["unet"]
    f = cfg.vae.downscale_factor
    gen = torch.Generator(device=DEV).manual_seed(8)
    with torch.inference_mode():
        lat = torch.randn((1, cfg.height // f, cfg.width // f,
                           cfg.vae.latent_channels), generator=gen,
                          device=DEV, dtype=torch.float32).to(g.dtype)
        ctx, _ = g.text_embeddings("a red barn", "", True)
        pair = torch.cat([lat, lat], dim=0)
        ts = torch.full((2,), 999.0, device=DEV)
        whole = unet_forward(p, cfg.unet, pair, ts, ctx).float()
        split = torch.cat([unet_forward(p, cfg.unet, lat, ts[i:i + 1],
                                        ctx[i:i + 1])
                           for i in range(2)], dim=0).float()
        mesh = _unet_dp([(torch.device(DEV), p)] * 2, cfg.unet, pair, ts,
                        ctx, None).float()
    out = dict(mesh_vs_split=(mesh - split).abs().max().item(),
               split_vs_whole=((split - whole).abs().max()
                               / whole.abs().max()).item())
    if out["mesh_vs_split"] != 0.0:
        fail(f"parallel (c): the --dp 2 mesh's UNet call differs from two "
             f"batch-1 calls by {out['mesh_vs_split']} ({g.dtype})")
    return out


def phase_parallel(torch, fa, i4, card: str, tree: str):
    """The parallel phase (ROADMAP A13 part 1): (a) the engine over a
    two-stage topology at tp 2 with two microbatches, on four mesh
    positions of the card, at 8 of Llama-3-8B's blocks; (b) the generator
    over stage 2 x dp 2 and int4 over stage 2 x tp 2; (c) Mixtral-width
    MoE over tp 2 and SD v1-5 over --dp 2; and rows 7-9 at the shard
    shapes. Returns ((a)'s measured sharded wave's launches, record)."""
    import dataclasses

    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.params import init_params

    from cake_tpu_torch.parallel.plan import HBM_BUDGET

    t0 = time.perf_counter()
    _release(torch)
    held = torch.cuda.memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"parallel: the card's total_memory {total} bytes, plan.HBM_BUDGET"
        f" {HBM_BUDGET} [{card}]")
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=PAR_LAYERS,
                              use_flash_attention=True)
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(21),
                         device=DEV, dtype=torch.float32)
    # greedy tokens in the byte range, never an EOS: every stream runs
    # to its budget
    params["lm_head"][:, 256:] = 0.0
    counts, served = _par_served(torch, fa, cfg, params, card)
    del params
    _release(torch)
    rec = dict(served=served, bf16=_par_bf16(torch, cfg, card))
    _release(torch)
    t1 = time.perf_counter()
    rec["kernels"] = _par_kernels(torch, fa, i4, card)
    rec["generators"] = _par_generators(torch, i4, card)
    t2 = time.perf_counter()
    rec["moe_sd"] = _par_moe_sd(torch, card, tree)
    rec["part_seconds"] = dict(a=t1 - t0, b=t2 - t1,
                               c=time.perf_counter() - t2)
    rec["seconds"] = time.perf_counter() - t0
    _release(torch)
    rec["held_gib"] = [held / 2**30, torch.cuda.memory_allocated() / 2**30]
    if torch.cuda.memory_allocated() > held + 2**30:
        fail(f"parallel: the phase kept {rec['held_gib']} GiB allocated")
    log(f"parallel phase: {rec['seconds']:.1f} s (co-located mesh: these "
        "times are sharding's cost on one card, not a parallel speed-up)")
    return counts, rec


# -- phase: sp --------------------------------------------------------------------

SP_N = 4                          # (a): --sp
SP_LAYERS = 8                     # (a), (c): Llama-3-8B width, 8 of 32 blocks
SP_T = 4112                       # --max-seq-len: a 4096 context, a 16 tail
SP_NEW = 16                       # --sample-len, and the tokens a chat
SP_CTX = 4096
SP_SLOTS = 4
SP_CHATS = (1000, 2000, 3000, 4000)   # (a): prompt tokens
SP_SCAN = 4                       # (a): --decode-scan of both engines
SP_GEN_LAYERS = 4                 # (b): blocks of the generator drives
SP_GEN_NEW = 8                    # (b): tokens of the f32 drive
SP_SHORT = (300, 900)             # (c): the short chats' tokens
SP_TOPOLOGY = PAR_TOPOLOGY        # (c): a 4 + 4 topology


def _sp_args(**kw):
    return _par_args(**{**dict(max_seq_len=SP_T, sample_len=SP_NEW,
                                max_slots=SP_SLOTS, prefill_chunk=None,
                                decode_scan=SP_SCAN), **kw})


def _sp_generator(torch, cfg, params, args, mesh_devices):
    """The generator Context.load_text_model builds for an --sp `args`
    (its sp branch: the refusals, JAX's sp mesh on `mesh_devices`, the
    window split, the SPGeneratorForward), over `params` (a tree made
    here, not loaded)."""
    from cake_tpu_torch.context import Context
    from cake_tpu_torch.models.llama.generator import (
        ByteTokenizer, LlamaGenerator,
    )
    from cake_tpu_torch.ops.sampling import SamplingConfig
    from cake_tpu_torch.parallel.plan import ParallelPlan

    ctx = Context.from_args(args, mesh_devices=mesh_devices)
    plan = ParallelPlan.from_topology(cfg, ctx.topology, args=args)
    ctx._check_sp(cfg, plan)
    kw = ctx._place_sp(cfg, plan, params, args.max_seq_len, ctx.dtype)
    params = kw.pop("params")
    return LlamaGenerator(cfg, params, ByteTokenizer(cfg.vocab_size),
                          max_seq_len=args.max_seq_len,
                          batch_size=args.batch_size,
                          sampling=SamplingConfig(temperature=0.0,
                                                  repeat_penalty=1.0),
                          cache_dtype=ctx.dtype, device=ctx.device, **kw)


def _sp_scan_check(torch, eng) -> bool:
    """The sp engine's captured decode step after its waves: one K = 4
    burst of replays against four bursts of one, every slot live from
    its prompt's end, the tails restored between: the same tokens."""
    import numpy as np

    from cake_tpu_torch.serve.graphs import DecodeRunner
    r, cache, B = eng._runner, eng.cache, eng.max_slots
    tails = cache.tail_k.distinct() + cache.tail_v.distinct()
    saved = [t.clone() for t in tails]
    plen = cache.plen.cpu().numpy()
    ones = np.ones(B, np.float32)

    def burst(ns):
        for t, v in zip(tails, saved):
            t.copy_(v)
        r.load(0, np.arange(B) + 40, plen, np.ones(B, bool),
               np.zeros(B, np.int64), 0 * ones, ones, ones)
        return np.concatenate([DecodeRunner.fetch(r.run(
            n, np.full(B, n), 0))[0] for n in ns], axis=1)

    with torch.inference_mode():
        got, want = burst([SP_SCAN]), burst([1] * SP_SCAN)
        for t, v in zip(tails, saved):
            t.copy_(v)
    if not (got == want).all():
        fail(f"sp (a): a {SP_SCAN}-step burst gave {got.tolist()}, "
             f"{SP_SCAN} single steps {want.tolist()}")
    return True


def _sp_served(torch, cfg, params, card: str) -> dict:
    """(a) the unsharded dense engine, then the engine over --sp 4 on
    four mesh positions of the card, both at --decode-scan 4 behind the
    HTTP API at f32: a warm-up wave, then a measured one whose streams
    must be the unsharded engine's and which captures nothing; the sp
    engine's windowed limits; its K = 4 burst against single steps."""
    rec, ref = {}, None
    for label in ("unsharded", "sp"):
        sp = label == "sp"
        args = _sp_args(**(dict(sp=SP_N) if sp else {}))
        gen = (_sp_generator(torch, cfg, params, args, [DEV] * SP_N) if sp
               else _par_generator(torch, cfg, params, args))
        srv = _ParServer(torch, gen, args)
        eng = srv.engine
        try:
            if sp != eng._custom_steps:
                fail(f"sp (a): make_engine built custom steps "
                     f"{eng._custom_steps} for the {label} generator")
            if sp and (eng.prompt_limit, eng.decode_budget) != (SP_CTX,
                                                                SP_NEW):
                fail(f"sp (a): prompt_limit {eng.prompt_limit}, "
                     f"decode_budget {eng.decode_budget}")
            caps = _count_captures(eng)
            _par_wave(srv, "w", SP_CHATS, SP_NEW, "sp (a)")
            n_caps = len(caps)
            del caps[:]
            r = _par_wave(srv, "m", SP_CHATS, SP_NEW, "sp (a)")
            r.update(captures=len(caps), warm_captures=n_caps,
                     cache_gib=eng.cache.memory_bytes() / 2**30)
            if r["captures"]:
                fail(f"sp (a) {label}: the measured wave captured "
                     f"{r['captures']} graph(s)")
            if not r["bursts"]:
                fail(f"sp (a) {label}: no {SP_SCAN}-step burst ran")
            if sp and not (eng._runner and eng._runner.captures
                           and eng._prefill_runner.captures == 1):
                fail("sp (a): the sp steps were not replayed graphs (one "
                     "prefill capture for the window expected)")
            log(f"sp (a) {label:<9}: TTFT p50 {r['ttft_p50_s']:.3f} s, "
                f"decode {r['decode_tok_s']:.1f} tok/s, decode replay "
                f"{r['decode_replay_ms']} ms, {r['bursts']} bursts, wall "
                f"{r['wall_s']:.2f} s, cache {r['cache_gib']:.3f} GiB "
                f"[{card}]")
        finally:
            srv.close()
        for t in threading.enumerate():
            if t.name == "cake-http":
                t.join(timeout=60)
        if sp:
            r["scan_equal"] = _sp_scan_check(torch, eng)
        gone = [weakref.ref(eng)]
        del srv, eng, gen
        _release(torch, gone)
        if ref is None:
            ref = r["streams"]
        elif r["streams"] != ref:
            same = sum(a == b for a, b in zip(r["streams"], ref))
            fail(f"sp (a): {same} of {len(ref)} f32 streams equal the "
                 "unsharded engine's")
        r.pop("streams")
        rec[label] = r
    return rec


def _sp_bf16(torch, cfg, card: str) -> dict:
    """(c) at bf16: one slot prefill of a 1000-token prompt over a 1024
    window and one decode step through the sp 4 engine steps against the
    unsharded model's, logits within PAR_BF16_TOL of their largest
    magnitude (the ring and the merge sum in another order; bf16 rounds
    apart)."""
    from cake_tpu_torch.models.llama import model as tm
    from cake_tpu_torch.models.llama.cache import KVCache
    from cake_tpu_torch.models.llama.params import init_params
    from cake_tpu_torch.parallel.context_parallel import (
        create_sp_engine_cache, make_sp_engine_step_fns, place_sp_params,
    )
    from cake_tpu_torch.parallel.mesh import make_sp_mesh

    ctx, tail, n, B = 1024, 16, 1000, 4
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(3),
                         device=DEV, dtype=torch.bfloat16)
    mesh = make_sp_mesh(sp=SP_N, devices=[DEV] * SP_N)
    placed = place_sp_params(mesh, cfg, params)
    fns = make_sp_engine_step_fns(mesh, cfg, ctx, tail,
                                  kv_dtype=torch.bfloat16)
    cache = create_sp_engine_cache(mesh, cfg, B, ctx, tail,
                                   kv_dtype=torch.bfloat16)
    rope = tm.RopeTables.create(cfg, ctx + tail, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(4)
    ids = torch.randint(0, cfg.vocab_size, (1, ctx), generator=gen,
                        device=DEV, dtype=torch.int32)
    plen = torch.tensor([n], dtype=torch.int32, device=DEV)
    dense = KVCache.create(cfg, B, ctx + tail, dtype=torch.bfloat16,
                           device=DEV)
    out = {}
    with torch.inference_mode():
        want, _ = tm.prefill_slot(params, ids, plen, 1, dense, rope, cfg)
        got, _ = fns[0](placed, ids, plen, 1, cache, rope, cfg)
        tok = torch.full((B, 1), 7, dtype=torch.int32, device=DEV)
        pos = torch.tensor([0, n, 0, 0], dtype=torch.int32, device=DEV)
        live = torch.tensor([False, True, False, False], device=DEV)
        want2, _ = tm.decode_step_ragged(params, tok, pos, live, dense,
                                         rope, cfg)
        got2, _ = fns[1](placed, tok, pos, live, cache, rope, cfg)
    for name, w, g in (("prefill", want, got), ("decode", want2[1], got2[1])):
        share = ((w - g).abs().max() / w.abs().max()).item()
        out[name] = share
        if not share <= PAR_BF16_TOL:
            fail(f"sp (c) bf16 {name}: logits differ by {share:.4f} of max "
                 f"|logits| (> {PAR_BF16_TOL})")
    log(f"sp (c) bf16: prefill and decode logits within {out['prefill']:.4f}"
        f" and {out['decode']:.4f} of max |logits| (tol {PAR_BF16_TOL}) "
        f"[{card}]")
    del params, placed, dense, cache
    return out


def _sp_generators(torch, i4, card: str) -> dict:
    """(b) the generator through Context.load_text_model (random weights
    from seed 0, SP_GEN_LAYERS blocks at 8B width) on a full 4096-token
    prompt: over sp 2 x tp 2 at f32, greedy-identical to the unsharded
    generator; then --quant int4 over sp 2 x tp 2 at bf16: its
    int4_matmul launches on the decode steps (counted from 0 just
    before) and no plain one, its prefill logits within PAR_BF16_TOL of
    max against the unsharded int4 generator's on the same prompt, and
    each block product at the tp shard shapes it launched at against
    its plain version within row 9's tolerance."""
    import dataclasses

    import numpy as np

    from cake_tpu_torch.context import Context
    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.ops.quant import group_size
    from cake_tpu_torch.parallel.sharding import local

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=SP_GEN_LAYERS,
                              use_flash_attention=True)
    prompt = np.random.default_rng(9).integers(
        3, 250, (1, SP_CTX)).astype(np.int32)
    plen = np.full((1,), SP_CTX, np.int32)
    rec, outs = {}, {}
    for label, kw in (("single", {}), ("sp2_tp2", dict(sp=2, tp=2))):
        args = _sp_args(batch_size=1, **kw)
        ctx = Context.from_args(args, mesh_devices=[DEV] * 4 if kw else None)
        ctx.llama_config = cfg
        g = ctx.load_text_model()
        if kw and g._forward_fn.ctx_len != SP_CTX:
            fail(f"sp (b): ctx_len {g._forward_fn.ctx_len}")
        t0 = time.perf_counter()
        outs[label] = g.generate_on_device(prompt, plen,
                                           SP_GEN_NEW).tolist()
        rec[f"{label}_s"] = time.perf_counter() - t0
        del g, ctx
        _release(torch)
    if outs["single"] != outs["sp2_tp2"]:
        fail(f"sp (b): sp 2 x tp 2 gave {outs['sp2_tp2']}, the unsharded "
             f"generator {outs['single']}")
    rec["identity"] = outs["single"][0]
    logits = {}
    for label, kw in (("single", {}), ("sp2_tp2", dict(sp=2, tp=2))):
        args = _sp_args(batch_size=1, quant="int4", dtype="bf16", **kw)
        ctx = Context.from_args(args, mesh_devices=[DEV] * 4 if kw else None)
        ctx.llama_config = cfg
        g = ctx.load_text_model()
        i4.reset_launch_counts()
        rec[f"int4_{label}_tokens"] = g.generate_on_device(
            prompt, plen, 4).tolist()[0]
        torch.cuda.synchronize()
        if kw:
            rec["int4_launches"] = n = dict(i4.LAUNCHES)
        logits[label] = _sp_prefill_logits(torch, g, prompt, plen)
        if not kw:
            del g, ctx
            _release(torch)
    if n["int4_matmul"] <= 0 or n["int4_matmul_plain"]:
        fail(f"sp (b): int4 launches {n}")
    share = ((logits["single"] - logits["sp2_tp2"]).abs().max()
             / logits["single"].abs().max()).item()
    rec["int4_logits_share"] = share
    if not share <= PAR_BF16_TOL:
        fail(f"sp (b): int4 sp 2 x tp 2 prefill logits differ from the "
             f"unsharded int4 generator's by {share} of max")
    gen = torch.Generator(device=DEV).manual_seed(10)
    errs = {}
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        for t in range(2):
            w = local(g.params["blocks"][name], tp=t).layer(0)
            gs = group_size(w)
            x = torch.randn((1, 2 * w.q.shape[0]), generator=gen,
                            device=DEV, dtype=torch.bfloat16)
            got = i4.int4_matmul(x, w.q, w.scale, g=gs)
            want = i4.int4_matmul_plain(x, w.q, w.scale, g=gs)
            err = ((got.float() - want.float()).abs().max()
                   / want.float().abs().max()).item()
            errs[f"{name}[{2 * w.q.shape[0]}->{w.q.shape[1]}]"] = err
            if not err <= TOL["bfloat16"]["rtol"]:
                fail(f"sp (b): int4_matmul over tp rank {t}'s {name} "
                     f"differs from its plain version by {err} of max")
    rec["int4_shard_errs"] = errs
    del g, ctx
    _release(torch)
    log(f"sp (b): sp 2 x tp 2 greedy-identical on a {SP_CTX}-token prompt; "
        f"int4: {n} launches, prefill logits within {share:.4f} of the "
        f"unsharded int4 generator's; shard shapes {errs} [{card}]")
    return rec


def _sp_prefill_logits(torch, g, prompt, plen):
    """The logits [V] f32 of g's prefill of `prompt` at plen - 1 over its
    scratch cache, what generate_on_device samples its first token from
    (run after a generate_on_device, which allocates the scratch)."""
    from cake_tpu_torch.models.llama.model import forward

    toks = torch.as_tensor(prompt, device=g.device)
    last = torch.as_tensor(plen, device=g.device) - 1
    with torch.inference_mode():
        if g._forward_fn is not None:
            logits, _ = g._forward_fn(g.params, toks, g._scratch, 0, g.rope,
                                      last_idx=last, is_prefill=True)
        else:
            logits, _ = forward(g.params, toks, g._scratch, 0, g.rope,
                                g.config, last_idx=last)
    return logits[0].float().clone()


def _sp_compositions(torch, cfg, params, card: str) -> dict:
    """(c) stage 2 x sp 2 (a 4 + 4 topology) and dp 2 x sp 2 engines on
    four mesh positions of the card, each greedy-identical to the
    unsharded dense engine on two full-window (4096-token) and two short
    prompts."""
    import numpy as np

    from cake_tpu_torch.master import Master

    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, 250, n).tolist()
               for n in (SP_CTX, SP_CTX) + SP_SHORT]
    rec, ref = {}, None
    for label, kw in (("unsharded", {}),
                      ("stage2_sp2", dict(sp=2, topology=_par_topology(
                          SP_TOPOLOGY))),
                      ("dp2_sp2", dict(sp=2, dp=2, batch_size=2))):
        args = _sp_args(decode_scan=1, **kw)
        gen = (_sp_generator(torch, cfg, params, args, [DEV] * 4) if kw
               else _par_generator(torch, cfg, params, args))
        eng = Master(args, text_generator=gen).make_engine()
        t0 = time.perf_counter()
        with eng:
            hs = [eng.submit(p, max_new_tokens=SP_NEW) for p in prompts]
            if not all(h.wait(600) for h in hs):
                fail(f"sp (c) {label}: a request did not finish")
        streams = [list(h._req.out_tokens) for h in hs]
        rec[label] = dict(wall_s=time.perf_counter() - t0,
                          custom=eng._custom_steps)
        gone = [weakref.ref(eng)]
        del eng, gen, hs
        _release(torch, gone)
        if ref is None:
            ref = streams
        elif streams != ref:
            same = sum(a == b for a, b in zip(streams, ref))
            fail(f"sp (c) {label}: {same} of {len(ref)} streams equal the "
                 "unsharded engine's")
    log(f"sp (c): stage 2 x sp 2 and dp 2 x sp 2 greedy-identical on two "
        f"full-window and two short prompts {rec} [{card}]")
    return rec


def phase_sp(torch, i4, card: str):
    """The sp phase (ROADMAP A13 part 1b) on meshes whose positions repeat
    the card (what sequence parallelism costs on one card, not a
    speed-up): (a) the engine over --sp 4 at 8 of Llama-3-8B's blocks,
    (b) the generator over sp 2 x tp 2 and its int4 tree, (c) stage 2 x
    sp 2 and dp 2 x sp 2 engines and one bf16 step. Returns ((b)'s int4
    drive's launches, record)."""
    import dataclasses

    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.params import init_params

    t0 = time.perf_counter()
    _release(torch)
    held = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=SP_LAYERS,
                              use_flash_attention=True)
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(21),
                         device=DEV, dtype=torch.float32)
    # greedy tokens in the byte range, never an EOS: every stream runs
    # to its budget
    params["lm_head"][:, 256:] = 0.0
    rec = dict(served=_sp_served(torch, cfg, params, card))
    t1 = time.perf_counter()
    rec["compositions"] = _sp_compositions(torch, cfg, params, card)
    del params
    _release(torch)
    rec["bf16"] = _sp_bf16(torch, cfg, card)
    _release(torch)
    t2 = time.perf_counter()
    rec["generators"] = _sp_generators(torch, i4, card)
    rec["part_seconds"] = dict(a=t1 - t0, c=t2 - t1,
                               b=time.perf_counter() - t2)
    rec["seconds"] = time.perf_counter() - t0
    _release(torch)
    rec["held_gib"] = [held / 2**30, torch.cuda.memory_allocated() / 2**30]
    if torch.cuda.memory_allocated() > held + 2**30:
        fail(f"sp: the phase kept {rec['held_gib']} GiB allocated")
    log(f"sp phase: {rec['seconds']:.1f} s (co-located mesh: these times "
        "are sequence parallelism's cost on one card, not a speed-up)")
    return {"int4_matmul": rec["generators"]["int4_launches"][
        "int4_matmul"]}, rec


# -- phase: multihost -------------------------------------------------------------

MH_LAYERS = 8                     # Llama-3-8B width, 8 of its 32 blocks
MH_T = 1024                       # --max-seq-len
MH_SLOTS = 4                      # --max-slots
MH_SCAN = 4                       # --decode-scan
MH_NEW = 16                       # tokens a chat
MH_CHATS = (160, 300, 180, 200)   # (a): the user messages' tokens
MH_WAVE = PAR_CHATS               # (b): eight chats
MH_LONG = 256                     # (c): the killed stream's tokens
MH_HB = 5.0                       # (c): --heartbeat-timeout
MH_EXTRA = ()                     # more CLI flags of every child
MH_SYSTEM = ("You answer briefly and exactly. Keep to the facts, and say "
             "so when a question cannot be answered from what you know.")
# a child: seed 0's random init (what load_text_params draws without
# weights on disk), its lm_head cut to the byte tokenizer's printable
# ASCII (ids 35-129: bytes 32-126) so greedy streams never reach an EOS
# and decode exactly; then the CLI
MH_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
import cake_tpu_torch.models as models
_load = models.load_text_params
def _printable(config, model_dir, dtype, device):
    p = _load(config, model_dir, dtype, device)
    with torch.no_grad():
        p["lm_head"][:, :35] = 0
        p["lm_head"][:, 130:] = 0
    return p
models.load_text_params = _printable
import cake_tpu_torch.master as master
_from_args = master.Master.from_args.__func__
def _loaded(cls, *a, **k):
    # the whole drawn tree is gone once placed: hand its blocks back, so
    # the three pairs and the references fit the card together
    m = _from_args(cls, *a, **k)
    torch.cuda.empty_cache()
    return m
master.Master.from_args = classmethod(_loaded)
from cake_tpu_torch import cli
sys.exit(cli.main(sys.argv[2:]))
"""


def _mh_get(url: str, timeout: float = 30.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mh_model_dir() -> str:
    """A model directory holding only config.json: Llama-3-8B at
    MH_LAYERS blocks (no weights: the CLI draws them)."""
    import tempfile

    from cake_tpu_torch.models.llama.config import LlamaConfig
    c = LlamaConfig.llama3_8b()
    d = tempfile.mkdtemp(prefix="cake_smoke_mh_model_")
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({
            "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
            "intermediate_size": c.intermediate_size,
            "num_hidden_layers": MH_LAYERS,
            "num_attention_heads": c.num_attention_heads,
            "num_key_value_heads": c.num_key_value_heads,
            "rms_norm_eps": c.rms_norm_eps, "rope_theta": c.rope_theta,
            "max_position_embeddings": c.max_position_embeddings,
            "bos_token_id": c.bos_token_id,
            "eos_token_id": list(c.eos_token_ids)}, f)
    return d


def _mh_params(torch, cfg, dtype):
    """The children's weights, drawn here: seed 0's init on the card,
    the lm_head cut to printable ASCII (MH_CHILD's cut)."""
    from cake_tpu_torch.models.llama.params import init_params
    p = init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                    device=DEV, dtype=dtype)
    with torch.no_grad():
        p["lm_head"][:, :35] = 0
        p["lm_head"][:, 130:] = 0
    return p


class _MhPair:
    """Two processes of `python -c MH_CHILD` (cli.main) serving one model
    over a mesh that spans them, the API on process 0."""

    def __init__(self, tree, model_dir, topo, dtype, tag, extra=()):
        import tempfile
        self.tmp = tempfile.mkdtemp(prefix=f"cake_smoke_mh_{tag}_")
        self.ckpt = os.path.join(self.tmp, "ckpt.json")
        api = _free_port()
        self.url = f"http://127.0.0.1:{api}"
        # topo None: no topology (an --sp pair, given in `extra`)
        argv = ["--model", model_dir,
                *(["--topology", topo] if topo else []), "--dtype", dtype,
                "--max-seq-len", str(MH_T), "--max-slots", str(MH_SLOTS),
                "--decode-scan", str(MH_SCAN), "--auto-prefix",
                "--checkpoint", self.ckpt, "--temperature", "0",
                "--repeat-penalty", "1.0", "--sample-len", str(MH_NEW),
                "--telemetry-interval", "0.5", "--api",
                f"127.0.0.1:{api}", *MH_EXTRA, *extra]
        port = _free_port()
        self.logs = [os.path.join(self.tmp, f"p{i}.log") for i in range(2)]
        _NATIVE["child_logs"].extend(self.logs)
        self.procs = []
        for i in range(2):
            env = dict(os.environ, CAKE_COORDINATOR=f"127.0.0.1:{port}",
                       CAKE_NUM_PROCESSES="2", CAKE_PROCESS_ID=str(i))
            with open(self.logs[i], "w") as log_f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", MH_CHILD, tree, *argv],
                    stdout=log_f, stderr=subprocess.STDOUT, env=env))
        self.tag = tag

    def tail(self, i: int, n: int = 3000) -> str:
        with open(self.logs[i]) as f:
            return f.read()[-n:]

    def wait_up(self, timeout: float = 300.0) -> float:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            if any(p.poll() is not None for p in self.procs):
                fail(f"multihost {self.tag}: a process died at startup:\n"
                     f"{self.tail(0)}\n---\n{self.tail(1)}")
            try:
                if _mh_get(self.url + "/api/v1/health",
                              timeout=2.0)["status"] == "ok":
                    return time.perf_counter() - t0
            except (OSError, ValueError):
                time.sleep(0.2)
        fail(f"multihost {self.tag}: the API never came up")

    def report(self, i: int) -> dict:
        """The process's teardown report line (cli._hop_report)."""
        with open(self.logs[i]) as f:
            lines = [ln for ln in f if "multihost report: " in ln]
        if not lines:
            fail(f"multihost {self.tag}: process {i} logged no report:\n"
                 f"{self.tail(i)}")
        return json.loads(lines[-1].split("multihost report: ", 1)[1])

    def term(self) -> None:
        """(d): SIGTERM to the coordinator (`reap` checks the exits)."""
        import signal
        self.procs[0].send_signal(signal.SIGTERM)

    def reap(self) -> list:
        """After `term`: the follower must exit 0, the coordinator 0 or
        -15, and the checkpoint must be on disk."""
        import signal
        try:
            rcs = [self.procs[1].wait(120), self.procs[0].wait(120)]
        except subprocess.TimeoutExpired:
            fail(f"multihost {self.tag}: SIGTERM did not end the pair:\n"
                 f"{self.tail(0)}\n---\n{self.tail(1)}")
        if rcs[0] != 0 or rcs[1] not in (0, -signal.SIGTERM):
            fail(f"multihost {self.tag}: after SIGTERM the follower exited "
                 f"{rcs[0]}, the coordinator {rcs[1]}:\n{self.tail(0)}\n---"
                 f"\n{self.tail(1)}")
        if not os.path.exists(self.ckpt):
            fail(f"multihost {self.tag}: no checkpoint on disk after "
                 "SIGTERM")
        return rcs

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _mh_body(tok, tag: str, n_prompt: int, n_new: int, stream: bool,
             system: str = MH_SYSTEM) -> dict:
    return {"messages": [{"role": "system", "content": system},
                         {"role": "user",
                          "content": _tagged_chat(tok, tag, n_prompt)}],
            "max_tokens": n_new, "temperature": 0.0, "stream": stream}


def _mh_chat(url: str, body: dict) -> dict:
    """One chat: its text, and with "stream" its first and last content
    event's times beside the send time."""
    t0 = time.perf_counter()
    if not body.get("stream"):
        with _post(url + "/api/v1/chat/completions", body) as r:
            text = json.loads(r.read())["choices"][0]["message"]["content"]
        return dict(text=text, t0=t0, t_first=None,
                    t_end=time.perf_counter())
    req = urllib.request.Request(
        url + "/api/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    pieces, t_first = [], None
    with urllib.request.urlopen(req, timeout=600) as r:
        for raw in r:
            line = raw.decode().rstrip("\n")
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            ev = json.loads(line[6:])
            if "error" in ev:
                raise RuntimeError(f"stream error: {ev['error']}")
            piece = ev["choices"][0]["delta"].get("content")
            if piece:
                if t_first is None:
                    t_first = time.perf_counter()
                pieces.append(piece)
    return dict(text="".join(pieces), t0=t0, t_first=t_first,
                t_end=time.perf_counter())


def _mh_wave(url: str, tok, chats, stream: bool, tag: str,
             n_new: int = MH_NEW) -> dict:
    """Chats of `chats` user tokens at once (threads): their texts by
    tag, and with streams TTFT p50 and the wave's decode tok/s (tokens
    after each first over the span from the earliest first token to the
    last token)."""
    out, errs = {}, {}

    def one(i, n):
        try:
            out[f"{tag}{i}"] = _mh_chat(
                url, _mh_body(tok, f"{tag}{i}", n, n_new, stream))
        except Exception as e:   # noqa: BLE001
            errs[f"{tag}{i}"] = repr(e)

    threads = [threading.Thread(target=one, args=(i, n))
               for i, n in enumerate(chats)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errs or len(out) != len(chats):
        fail(f"multihost [{tag}]: chats failed {errs}")
    rec = dict(wall_s=time.perf_counter() - t0,
               texts={k: v["text"] for k, v in sorted(out.items())})
    if stream:
        firsts = [v["t_first"] for v in out.values()]
        rec["ttft_p50_s"] = statistics.median(
            v["t_first"] - v["t0"] for v in out.values())
        span = max(v["t_end"] for v in out.values()) - min(firsts)
        rec["decode_tok_s"] = len(chats) * (n_new - 1) / span
    return rec


def _mh_metrics(url: str) -> dict:
    """The coordinator's /metrics samples (federated ones included)."""
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        text = r.read().decode()
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            k, v = ln.rsplit(" ", 1)
            out[k] = float(v)
    return out


def _mh_captures(m: dict) -> tuple:
    """(this process's, proc1's) cake_jit_compiles_total."""
    local = sum(v for k, v in m.items()
                if k.startswith("cake_jit_compiles_total")
                and 'host="' not in k)
    remote = sum(v for k, v in m.items()
                 if k.startswith("cake_jit_compiles_total")
                 and 'host="proc1"' in k)
    return local, remote


def _mh_drained(url: str, timeout: float = 60.0) -> dict:
    """Wait until proc1 has applied every published op (lag 0); the
    fleet view."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        f = _mh_get(url + "/api/v1/fleet", timeout=10)
        h = f.get("hosts", {}).get("proc1", {})
        if (h.get("lag_ops") == 0 and f.get("published_seq")
                and h.get("applied_seq") == f["published_seq"]):
            # the frame that reports the last op applied carries the
            # registry as it stood then: every capture of those ops in it
            return f
        time.sleep(0.2)
    fail(f"multihost: proc1 never reported lag 0: {f}")


def _mh_publish_p50(before: dict, after: dict) -> float:
    """cake_control_publish_seconds' p50 over the samples between two
    scrapes (the upper bound of the bucket holding the median)."""
    pre = "cake_control_publish_seconds_bucket{le=\""
    buckets = sorted(
        (float("inf") if k[len(pre):-2] == "+Inf" else float(k[len(pre):-2]),
         after[k] - before.get(k, 0.0))
        for k in after if k.startswith(pre))
    total = buckets[-1][1] if buckets else 0
    for le, n in buckets:
        if total and n >= total / 2:
            return le
    return float("nan")


def _mh_reference(torch, cfg, dtype, args_kw, tok, drives, card,
                  mesh_devices=None) -> dict:
    """The single-process engine (unsharded, or over a co-located mesh
    with a topology in args_kw) over the children's weights, behind the
    HTTP API: drives(url) -> its record."""
    params = _mh_params(torch, cfg, dtype)
    kw = dict(max_seq_len=MH_T, max_slots=MH_SLOTS, decode_scan=MH_SCAN,
              auto_prefix=True, sample_len=MH_NEW, prefill_chunk=None,
              dtype="f32" if dtype == torch.float32 else "bf16")
    kw.update(args_kw)
    args = _par_args(**kw)
    gen = (_sp_generator(torch, cfg, params, args, mesh_devices)
           if args.sp > 1 else
           _par_generator(torch, cfg, params, args,
                          mesh_devices=mesh_devices))
    del params
    srv = _ParServer(torch, gen, args)
    eng = srv.engine
    try:
        rec = drives(srv.url)
    finally:
        srv.close()
    for t in threading.enumerate():
        if t.name == "cake-http":
            t.join(timeout=60)
    gone = [weakref.ref(eng)]
    del srv, eng, gen
    _release(torch, gone)
    return rec


def _mh_kernels(torch, fa, i4, card: str) -> dict:
    """Rows 7, 8 and 9 at the shapes a stage of the pair launches them
    at (one stage a process, no tp: every head): flash_attn over 32
    query and 8 kv heads of a 512-token prompt, flash_attn_cached over a
    256-token window at pos 256 of a 1024-slot cache, at f32 ((a)'s
    scalar bodies) and bf16 ((b)'s tensor-core bodies); int4_matmul at
    the four slots of a decode step over wq / wo [4096 -> 4096] and
    w_down [14336 -> 4096]."""
    from cake_tpu_torch.ops.quant import quantize_group

    gen = torch.Generator(device=DEV).manual_seed(6)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=DEV, dtype=dtype)

    rec = {}
    pos = torch.tensor([256], dtype=torch.int32, device=DEV)
    for dname, dt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        q, k, v = (rnd(1, 512, 32, 128, dtype=dt),
                   rnd(1, 512, 8, 128, dtype=dt), rnd(1, 512, 8, 128, dtype=dt))
        got = fa.flash_attention(q, k, v, causal=True)
        want = fa.flash_attention_plain(q, k, v, causal=True)
        errs = dict(flash_attn=(got.float() - want.float()).abs().max().item())
        kc, vc = rnd(1, MH_T, 8, 128, dtype=dt), rnd(1, MH_T, 8, 128, dtype=dt)
        qw = rnd(1, 256, 32, 128, dtype=dt)
        got = fa.flash_attention_cached(qw, kc, vc, pos)
        want = fa.flash_attention_cached_plain(qw, kc, vc, pos)
        errs["flash_attn_cached"] = (got.float()
                                     - want.float()).abs().max().item()
        for name, err in errs.items():
            rec[f"{name}_{dname}"] = err
            if not err <= TOL[dname]["atol"]:
                fail(f"multihost: {name} at a stage's shapes, {dname}, "
                     f"differs from its plain version by {err} (tol "
                     f"{TOL[dname]['atol']})")
    for name, (In, Out) in (("wq", (4096, 4096)), ("wo", (4096, 4096)),
                            ("w_down", (14336, 4096))):
        w = quantize_group(rnd(In, Out, dtype=torch.float32), 0)
        g = 2 * w.q.shape[0] // w.scale.shape[0]
        x = rnd(MH_SLOTS, In)
        got = i4.int4_matmul(x, w.q, w.scale, g=g)
        want = i4.int4_matmul_plain(x, w.q, w.scale, g=g)
        err = ((got.float() - want.float()).abs().max()
               / want.float().abs().max()).item()
        rec[f"int4_{name}"] = err
        if not err <= TOL["bfloat16"]["rtol"]:
            fail(f"multihost: int4_matmul over {name} [{In} -> {Out}] at "
                 f"M = {MH_SLOTS}: share {err}")
    log(f"multihost kernels at a stage's shapes: {rec} [{card}]")
    return rec


MH_SP_T = 2064                    # (e): --max-seq-len: a 2048 context
MH_SP_CTX = 2048
MH_SP_SHORT = (200, 500)          # (e): the short chats' user tokens
MH_SD_STEPS = 20                  # (f): DDIM steps at guidance 7.5
MH_SD_LEVELS = 1                  # (f): u8 levels the pair's image may differ


MH_SP_EXTRA = ("--sp", "2", "--max-seq-len", str(MH_SP_T))


def _mh_sp_chats(tok) -> tuple:
    """(e)'s chats: two that fill the 2048-token window and two short
    ones, each prompt's tokens less the system block's."""
    from cake_tpu_torch.models.chat import History, Message

    h = History("llama3")
    h.add_message(Message.system(MH_SYSTEM))
    h.add_message(Message.user(""))
    bare = History("llama3")
    bare.add_message(Message.user(""))
    sys_block = len(tok.encode(h.render())) - len(tok.encode(bare.render()))
    chats = (MH_SP_CTX - sys_block - 1, MH_SP_CTX - sys_block - 9,
             *MH_SP_SHORT)
    return chats, [n + sys_block for n in chats]


def _mh_sp_identity(torch, cfg, tok, card: str, f32) -> dict:
    """(e) --sp 2 across the two processes at f32: each owns one sp
    position of a 2048-token context (the ring's chunks and a decode
    step's q and stats cross by hop). Two full-window chats and two
    short ones, a warm SSE wave then a measured one: every text the
    single-process co-located --sp 2 engine's and the unsharded
    engine's, no capture in the measured wave on either process. `f32`:
    the pair, started by the caller. Untimed (other processes start
    meanwhile): no TTFT or tok/s is kept."""
    chats, tokens = _mh_sp_chats(tok)
    t0 = time.perf_counter()
    rec: dict = {"chat_tokens": tokens}

    def drives(url):      # the texts alone: one wave
        return _mh_wave(url, tok, chats, True, "s")

    ref = {"unsharded": _mh_reference(
        torch, cfg, torch.float32, dict(max_seq_len=MH_SP_T,
                                        auto_prefix=False),
        tok, drives, card)}
    ref["co-located sp 2"] = _mh_reference(
        torch, cfg, torch.float32, dict(sp=2, max_seq_len=MH_SP_T,
                                        auto_prefix=False),
        tok, drives, card, mesh_devices=[DEV] * 2)
    rec["f32_startup_s"] = f32.wait_up()
    url = f32.url
    _mh_wave(url, tok, chats, True, "s")
    _mh_drained(url)
    m0 = _mh_metrics(url)
    got = _mh_wave(url, tok, chats, True, "s")
    _mh_drained(url)
    m1 = _mh_metrics(url)
    f32.kill()
    caps = [b - a for a, b in zip(_mh_captures(m0), _mh_captures(m1))]
    for label, r in ref.items():
        if got["texts"] != r["texts"]:
            same = sum(got["texts"][k] == r["texts"].get(k)
                       for k in got["texts"])
            fail(f"multihost (e): {same} of {len(chats)} f32 texts of "
                 f"the sp 2 pair equal the {label} engine's")
    if any(caps):
        fail(f"multihost (e): the measured wave captured {caps} graphs "
             "(coordinator, follower)")
    rec["f32"] = dict(texts_equal=True, warm_captures=caps)
    log(f"multihost (e) f32: --sp 2 across two processes, "
        f"{len(chats)} chats of {tokens} tokens: every text the "
        f"co-located sp 2 engine's and the unsharded engine's; the "
        f"measured wave's captures {caps} [{card}]")
    rec["f32_seconds"] = time.perf_counter() - t0
    return rec


def _mh_sp_cost(torch, cfg, tok, card: str, bf16) -> dict:
    """(e) at bf16: the pair (`bf16`, started by the caller, awaited
    here before anything is timed) beside the single-process co-located
    sp 2 engine, a warm wave then the measured one each: TTFT p50,
    decode tok/s, the hops a decode step and a hop's host seconds (the
    processes' teardown reports)."""
    chats, _ = _mh_sp_chats(tok)
    t0 = time.perf_counter()
    rec: dict = {"bf16_startup_s": bf16.wait_up()}

    def cost(url):
        _mh_wave(url, tok, chats, True, "b")
        return _mh_wave(url, tok, chats, True, "b")

    bf = {"co-located sp 2": _mh_reference(
        torch, cfg, torch.bfloat16, dict(sp=2, max_seq_len=MH_SP_T,
                                         auto_prefix=False),
        tok, cost, card, mesh_devices=[DEV] * 2)}
    bf["two processes"] = cost(bf16.url)
    bf16.term()
    bf16.reap()
    reports = [bf16.report(i) for i in range(2)]
    bf["two processes"]["processes"] = [
        dict(hops=r["hops"], hop_ms=(1e3 * r["hop_seconds"] / r["hops"]
                                     if r["hops"] else None),
             decode_graphs=r["decode_segments"]) for r in reports]
    for label, r in bf.items():
        r.pop("texts")
        log(f"multihost (e) bf16 {label:<15}: TTFT p50 "
            f"{r['ttft_p50_s']:.3f} s, decode {r['decode_tok_s']:.1f} "
            f"tok/s, wall {r['wall_s']:.2f} s"
            + (f", processes {r['processes']} (a decode step's hops: "
               "its graphs less one)" if "processes" in r else "")
            + f" [{card}]")
    rec["bf16"] = bf
    rec["bf16_seconds"] = time.perf_counter() - t0
    return rec


def _mh_image_start(tree) -> dict:
    """(f)'s two processes started (`_mh_image_up` awaits them)."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="cake_smoke_mh_sd_")
    port, api = _free_port(), _free_port()
    logs = [os.path.join(tmp, f"p{i}.log") for i in range(2)]
    _NATIVE["child_logs"].extend(logs)
    procs = []
    for i in range(2):
        env = dict(os.environ, CAKE_COORDINATOR=f"127.0.0.1:{port}",
                   CAKE_NUM_PROCESSES="2", CAKE_PROCESS_ID=str(i),
                   PYTHONPATH=tree)
        with open(logs[i], "w") as log_f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "cake_tpu_torch.cli", "--model-type",
                 "image", "--sd-version", "v1-5", "--api",
                 f"127.0.0.1:{api}"], stdout=log_f,
                stderr=subprocess.STDOUT, env=env))
    return dict(procs=procs, logs=logs, url=f"http://127.0.0.1:{api}",
                t0=time.perf_counter())


def _mh_image_up(started: dict, timeout: float = 300.0) -> float:
    """(f)'s pair up (its health ok): the seconds since its start."""
    procs, logs, url = started["procs"], started["logs"], started["url"]
    deadline = time.perf_counter() + timeout
    while True:
        if any(p.poll() is not None for p in procs):
            tails = []
            for lp in logs:
                with open(lp) as f:
                    tails.append(f.read()[-3000:])
            fail(f"multihost (f): a process died:\n{tails[0]}\n---\n"
                 f"{tails[1]}")
        try:
            if _mh_get(url + "/api/v1/health", 2.0)["status"] == "ok":
                return time.perf_counter() - started["t0"]
        except (OSError, ValueError):
            if time.perf_counter() > deadline:
                fail("multihost (f): the image API never came up")
            time.sleep(0.2)


def _mh_image(torch, started: dict, card: str) -> dict:
    """(f) SD v1-5 at its published 512 x 512, bf16 random weights, over
    two processes (one dp position each: a process runs its half of the
    guidance-doubled UNet batch, the halves cross by hop): SD_STEPS DDIM
    steps at guidance 7.5 through POST /api/v1/image on process 0, the
    follower replaying the generation; the PNG within MH_SD_LEVELS u8
    levels of the single-process co-located --dp 2 generator's (the same
    seed); seconds an image beside it (the second request each);
    img2img refused with JAX's message. The caller has awaited the pair
    (`_mh_image_up`): it idles while the reference is timed."""
    import base64
    import signal

    from cake_tpu_torch.args import (
        Args, ImageGenerationArgs, ModelType, SDArgs,
    )
    from cake_tpu_torch.master import Master
    from cake_tpu_torch.models.sd.image import decode_png

    body = {"image_prompt": "a red barn in a snowy field",
            "sd_n_steps": MH_SD_STEPS, "sd_guidance_scale": 7.5,
            "sd_seed": 3}
    t0 = time.perf_counter()
    procs, logs, url = started["procs"], started["logs"], started["url"]

    def tail(i):
        with open(logs[i]) as f:
            return f.read()[-3000:]

    rec: dict = {}
    try:
        # the reference (the pair idles, up): one process, the co-located
        # --dp 2 mesh
        master = Master.from_args(
            Args(model_type=ModelType.IMAGE, dp=2, cpu=DEV == "cpu"),
            SDArgs(sd_version="v1-5"), mesh_devices=[DEV] * 2)
        want, secs = None, []
        for _ in range(2):
            out = []
            t1 = time.perf_counter()
            master.generate_image(ImageGenerationArgs(**body), out.extend)
            secs.append(time.perf_counter() - t1)
            want = decode_png(out[0])
        rec["co-located dp 2_s"] = secs
        del master
        _release(torch)
        secs, got = [], None
        for _ in range(2):
            t1 = time.perf_counter()
            code, out = _http_json(url + "/api/v1/image", body)
            secs.append(time.perf_counter() - t1)
            if code != 200:
                fail(f"multihost (f): /api/v1/image got {code} "
                     f"{str(out)[:300]}")
            got = decode_png(base64.b64decode(out["images"][0]))
        rec["two processes_s"] = secs
        diff = int(abs(got.astype(int) - want.astype(int)).max())
        rec["max_level_diff"] = diff
        if got.shape != (512, 512, 3) or want.std() == 0 \
                or diff > MH_SD_LEVELS:
            fail(f"multihost (f): the pair's image {got.shape} differs from "
                 f"the co-located --dp 2 image by {diff} levels")
        code, out = _http_json(url + "/api/v1/image",
                               dict(body, sd_img2img="/nonexistent.png"))
        want_msg = ("img2img is unavailable under multi-host serving: the "
                    "init image exists on the coordinator only; serve "
                    "img2img on one host")
        if code not in (400, 500) or want_msg not in str(out):
            fail(f"multihost (f): img2img got {code} {out}")
        procs[0].send_signal(signal.SIGTERM)
        rcs = [procs[1].wait(120), procs[0].wait(120)]
        if rcs[0] != 0 or "image follower: coordinator stopped" not in \
                tail(1):
            fail(f"multihost (f): the follower exited {rcs[0]}:\n{tail(1)}")
        rec["rcs"] = rcs
        log(f"multihost (f) SD v1-5 512 x 512 bf16 over two processes: "
            f"{MH_SD_STEPS} steps in {secs[-1]:.2f} s an image (co-located "
            f"--dp 2: {rec['co-located dp 2_s'][-1]:.2f} s), the PNG "
            f"{diff} u8 levels from the co-located image; img2img refused "
            f"({code}); follower exit {rcs[0]} [{card}]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def phase_multihost(torch, fa, i4, card: str, tree: str):
    """The multihost phase (ROADMAP A13 part 2; see the module
    docstring). Returns (the pairs' processes' kernel launches, the
    record)."""
    import dataclasses

    from cake_tpu_torch.models.llama.config import load_config
    from cake_tpu_torch.models.llama.generator import ByteTokenizer

    t0 = time.perf_counter()
    _release(torch)
    held = torch.cuda.memory_allocated()
    model_dir = _mh_model_dir()
    topo = _par_topology()
    cfg = dataclasses.replace(load_config(model_dir),
                              use_flash_attention=True)
    tok = ByteTokenizer(cfg.vocab_size)
    second = _mh_body(tok, "second", 220, MH_NEW, False)
    long_body = _mh_body(tok, "long", 200, MH_LONG, True)
    pairs = []
    later: list = []       # (e)'s and (f)'s, started after (c)
    parts: dict = {}
    try:
        # the three pairs start while the kernels and the f32 reference
        # run: the f32 pair for (a) and (c), the bf16 and int4 pairs for
        # (b) and (d)
        f32 = _MhPair(tree, model_dir, topo, "f32", "f32",
                      ("--heartbeat-timeout", str(MH_HB)))
        bf16 = _MhPair(tree, model_dir, topo, "bf16", "bf16")
        q4 = _MhPair(tree, model_dir, topo, "bf16", "int4",
                     ("--quant", "int4"))
        pairs += [f32, bf16, q4]
        rec: dict = {"kernels": _mh_kernels(torch, fa, i4, card)}

        def ref_drives(url):
            out = {w: _mh_wave(url, tok, MH_CHATS, w != "A", "c")["texts"]
                   for w in ("A", "B")}
            out["second"] = _mh_chat(url, second)["text"]
            out["long"] = _mh_chat(url, long_body)["text"]
            return out

        ref = _mh_reference(torch, cfg, torch.float32, {}, tok, ref_drives,
                            card)
        parts["reference"] = time.perf_counter() - t0
        rec["f32_startup_s"] = f32.wait_up()
        url = f32.url
        cluster = _mh_get(url + "/api/v1/cluster", timeout=10)
        if cluster.get("process_count") != 2 or not cluster.get("backend"):
            fail(f"multihost (a): /api/v1/cluster {cluster}")
        waves = {w: _mh_wave(url, tok, MH_CHATS, w != "A", "c")
                 for w in ("A", "B")}
        _mh_drained(url)
        m0 = _mh_metrics(url)
        waves["C"] = _mh_wave(url, tok, MH_CHATS, True, "c")
        fleet = _mh_drained(url)
        m1 = _mh_metrics(url)
        caps = [b - a for a, b in zip(_mh_captures(m0), _mh_captures(m1))]
        got_second = _mh_chat(url, second)["text"]
        for w, r in waves.items():
            want = ref["B" if w != "A" else "A"]
            if r["texts"] != want:
                same = sum(r["texts"][k] == want.get(k) for k in r["texts"])
                fail(f"multihost (a) wave {w}: {same} of {len(want)} f32 "
                     "texts equal the unsharded engine's")
        if got_second != ref["second"]:
            fail("multihost (a): the second conversation's text is not "
                 "the unsharded engine's")
        hits = m1.get("cake_engine_prefix_hits_total", 0)
        reg = m1.get('cake_control_ops_total{op="register_prefix"}', 0)
        if hits <= 0 or reg < 1:
            fail(f"multihost (a): prefix hits {hits}, register_prefix ops "
                 f"{reg}")
        if any(caps):
            fail(f"multihost (a): the warm SSE wave captured {caps} graphs "
                 "(coordinator, follower)")
        p1 = fleet["hosts"]["proc1"]
        rec["a"] = dict(cluster=cluster, prefix_hits=hits,
                        register_prefix_ops=reg, warm_captures=caps,
                        proc1=dict(lag_ops=p1["lag_ops"],
                                   applied_seq=p1["applied_seq"]),
                        published_seq=fleet["published_seq"],
                        captures_total=_mh_captures(m1))
        log(f"multihost (a) f32: {len(MH_CHATS)} chats x 3 waves and the "
            f"second conversation equal the unsharded engine's; prefix "
            f"hits {hits:.0f}, register_prefix ops {reg:.0f}, the warm "
            f"wave's captures {caps}, backend {cluster['backend']}, proc1 "
            f"lag {p1['lag_ops']} [{card}]")

        parts["a"] = time.perf_counter() - t0

        # (c): the follower dies in the middle of a long stream
        killed = []

        def stream_long():
            try:
                req = urllib.request.Request(
                    url + "/api/v1/chat/completions",
                    data=json.dumps(long_body).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    n = 0
                    for raw in r:
                        if raw.startswith(b"data: ") and b"content" in raw:
                            n += 1
                            if n == 2 and not killed:
                                f32.procs[1].kill()
                                killed.append(time.perf_counter())
            except Exception:   # noqa: BLE001 — torn down by the failure
                pass

        th = threading.Thread(target=stream_long)
        th.start()
        th.join(timeout=300)
        if not killed:
            fail("multihost (c): the stream ended before the follower was "
                 "killed")
        health = None
        while time.perf_counter() - killed[0] < MH_HB + 10:
            health = _mh_get(url + "/api/v1/health", timeout=10)
            if health["status"] == "failed":
                break
            time.sleep(0.1)
        t_failed = time.perf_counter() - killed[0]
        if health["status"] != "failed" or "proc1" not in str(
                health.get("reason")):
            fail(f"multihost (c): health after the kill: {health}")
        try:
            _post(url + "/api/v1/chat/completions",
                  _mh_body(tok, "late", 200, 2, False)).close()
            fail("multihost (c): a chat after the failure was served")
        except urllib.error.HTTPError as e:
            if e.code != 503:
                fail(f"multihost (c): a chat after the failure got {e.code}")
        with open(f32.ckpt) as f:
            snap = json.load(f)
        live = [r for r in snap["requests"]
                if not r["finished"] and not r["error"]]
        if len(live) != 1 or not 1 <= len(live[0]["out_tokens"]) < MH_LONG:
            fail(f"multihost (c): the pre-fail snapshot holds {live}")
        done = tok.decode(live[0]["out_tokens"])
        if not ref["long"].startswith(done):
            fail("multihost (c): the snapshot's tokens are not the "
                 "reference's")
        rec["c"] = dict(failed_after_s=t_failed, reason=health["reason"],
                        snapshot_tokens=len(live[0]["out_tokens"]))
        log(f"multihost (c): serving failed {t_failed:.2f} s after the "
            f"kill ('{health['reason']}'), a new chat 503, the snapshot "
            f"holds the stream at {len(live[0]['out_tokens'])} tokens "
            f"[{card}]")
        # its coordinator goes too ((d) is a healthy pair's SIGTERM)
        f32.kill()
        parts["c"] = time.perf_counter() - t0
        # (e)'s f32 pair and (f)'s pair start while only untimed drives
        # run: (e)'s f32 identities and the int4 pair's wave
        sp_f32 = _MhPair(tree, model_dir, None, "f32", "sp_f32",
                         MH_SP_EXTRA)
        later.append(sp_f32)
        sd = _mh_image_start(tree)
        later += sd["procs"]
        rec["e"] = _mh_sp_identity(torch, cfg, tok, card, sp_f32)
        parts["e_f32"] = time.perf_counter() - t0
        # row 9 on the int4 pair
        rec["int4_startup_s"] = q4.wait_up()
        _mh_wave(q4.url, tok, MH_WAVE, True, "q")

        # (b): every process started so far is up, and idles, before the
        # single-process engines and the bf16 pair are timed
        def cost_drives(u):
            _mh_wave(u, tok, MH_WAVE, True, "w")
            return _mh_wave(u, tok, MH_WAVE, True, "m")

        rec["bf16_startup_s"] = bf16.wait_up()
        rec["f_startup_s"] = _mh_image_up(sd)
        cost = {"unsharded": _mh_reference(torch, cfg, torch.bfloat16, {},
                                           tok, cost_drives, card)}
        cost["co-located"] = _mh_reference(
            torch, cfg, torch.bfloat16, dict(topology=topo), tok,
            cost_drives, card, mesh_devices=[DEV] * 2)
        parts["b_references"] = time.perf_counter() - t0
        _mh_wave(bf16.url, tok, MH_WAVE, True, "w")
        m0 = _mh_metrics(bf16.url)
        cost["two processes"] = _mh_wave(bf16.url, tok, MH_WAVE, True, "m")
        m1 = _mh_metrics(bf16.url)
        cost["two processes"]["publish_p50_s"] = _mh_publish_p50(m0, m1)
        # (e)'s bf16 pair starts while (d) stops the stage pairs: both
        # pairs' SIGTERM at once
        sp_bf16 = _MhPair(tree, model_dir, None, "bf16", "sp_bf16",
                          MH_SP_EXTRA)
        later.append(sp_bf16)
        bf16.term()
        q4.term()
        rcs = bf16.reap()
        q4.reap()
        reports = [bf16.report(i) for i in range(2)]
        cost["two processes"]["processes"] = [
            dict(hop_ms=(1e3 * r["hop_seconds"] / r["hops"]
                         if r["hops"] else None),
                 hops=r["hops"], decode_graphs=r["decode_segments"])
            for r in reports]
        for label, r in cost.items():
            r.pop("texts")
            log(f"multihost (b) bf16 {label:<13}: TTFT p50 "
                f"{r['ttft_p50_s']:.3f} s, decode {r['decode_tok_s']:.1f} "
                f"tok/s, wall {r['wall_s']:.2f} s"
                + (f", publish p50 <= {r['publish_p50_s']} s, processes "
                   f"{r['processes']}" if "processes" in r else "")
                + f" [{card}]")
        rec["b"] = cost
        launches: dict = {}
        for r in reports:
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
        q4_reports = [q4.report(i) for i in range(2)]
        n4 = [r["launches"].get("int4_matmul", 0) for r in q4_reports]
        if min(n4) <= 0:
            fail(f"multihost (b) int4: int4_matmul launches {n4}")
        launches["int4_matmul"] = sum(n4)
        for k in ("flash_attn", "flash_attn_cached"):
            if launches.get(k, 0) <= 0:
                fail(f"multihost (b): {k} never launched on the pair")
        plain = {k: n for r in reports + q4_reports
                 for k, n in r["launches"].items() if k.endswith("_plain")}
        if plain:
            fail(f"multihost: plain versions ran {plain}")
        rec["d"] = dict(bf16_rcs=rcs)
        rec["launches"] = launches
        parts["b_d"] = time.perf_counter() - t0
        rec["part_ends_s"] = parts     # (e) and (f) add theirs below
        log(f"multihost (d): SIGTERM: follower {rcs[0]}, coordinator "
            f"{rcs[1]}, checkpoint on disk; int4 launches {n4}; the pairs' "
            f"launches {launches} [{card}]")
        for p in pairs:
            p.kill()
        rec["e"].update(_mh_sp_cost(torch, cfg, tok, card, sp_bf16))
        parts["e"] = time.perf_counter() - t0
        rec["f"] = _mh_image(torch, sd, card)
        parts["f"] = time.perf_counter() - t0
    finally:
        for p in pairs + later:
            if isinstance(p, _MhPair):
                p.kill()
            elif p.poll() is None:
                p.kill()
                p.wait()
    _release(torch)
    rec["seconds"] = time.perf_counter() - t0
    if torch.cuda.memory_allocated() > held + 2**30:
        fail("multihost: the phase kept memory allocated")
    log(f"multihost phase: {rec['seconds']:.1f} s")
    return launches, rec


# -- phase: router ------------------------------------------------------------

RT_LAYERS = 8                     # (b)-(d): Llama-3-8B width, 8 of 32 blocks
RT_F32_LAYERS = 2                 # (a), (c) kill: 2 blocks at f32
RT_T = 2048                       # the replicas' --max-seq-len
RT_PAGES = 256                    # --kv-pages (128-token pages)
RT_SLOTS = 8                      # --max-slots
RT_NEW = 16                       # tokens a chat
RT_TENANTS = (256, 420, 600)      # the tenants' system prompts' tokens
RT_CHATS = 4                      # chats a tenant
RT_LONG = 64                      # (c): the killed and drained streams' tokens
RT_TOKEN = "cake-smoke-announce"  # $CAKE_ANNOUNCE_TOKEN of the phase
# a replica: MH_CHILD with its lm_head cut to the BPE tokenizer's
# printable ASCII byte tokens (ids 32-126: no EOS, no partial UTF-8),
# SIGUSR1 zeroing the kernels' launch counts and SIGUSR2 printing them
RT_CHILD = MH_CHILD.replace('p["lm_head"][:, :35] = 0',
                            'p["lm_head"][:, :32] = 0').replace(
    'p["lm_head"][:, 130:] = 0', 'p["lm_head"][:, 127:] = 0').replace(
    "from cake_tpu_torch import cli\n", """import json, signal
from cake_tpu_torch.serve.graphs import COUNTERS
def _zero(*_):
    for c in COUNTERS:
        for k in c:
            c[k] = 0
def _report(*_):
    print("router child launches: " + json.dumps(
        {k: n for c in COUNTERS for k, n in c.items()}), flush=True)
signal.signal(signal.SIGUSR1, _zero)
signal.signal(signal.SIGUSR2, _report)
from cake_tpu_torch import cli
""")


def _rt_model_dir(layers: int) -> str:
    """config.json (Llama-3-8B width at `layers` blocks, the tokenizer's
    special ids) and the byte-level BPE tokenizer.json the replicas and
    the router read; no weights (a replica draws seed 0's)."""
    import tempfile

    from cake_tpu_torch.models.llama.config import LlamaConfig
    spec, specials = _tokenizer_json()
    c = LlamaConfig.llama3_8b()
    d = tempfile.mkdtemp(prefix="cake_smoke_rt_model_")
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({
            "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
            "intermediate_size": c.intermediate_size,
            "num_hidden_layers": layers,
            "num_attention_heads": c.num_attention_heads,
            "num_key_value_heads": c.num_key_value_heads,
            "rms_norm_eps": c.rms_norm_eps, "rope_theta": c.rope_theta,
            "max_position_embeddings": c.max_position_embeddings,
            "bos_token_id": specials["<|begin_of_text|>"],
            "eos_token_id": [specials["<|end_of_text|>"],
                             specials["<|eot_id|>"]]}, f)
    with open(os.path.join(d, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    return d


class _RtProc:
    """One process of the phase (a replica or the router), its log."""

    def __init__(self, argv, tag: str, tree: str):
        import tempfile
        self.tag = tag
        self.log = os.path.join(tempfile.mkdtemp(prefix=f"cake_rt_{tag}_"),
                                "log")
        _NATIVE["child_logs"].append(self.log)
        env = dict(os.environ, CAKE_ANNOUNCE_TOKEN=RT_TOKEN,
                   PYTHONPATH=tree)
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(argv, stdout=f,
                                         stderr=subprocess.STDOUT, env=env)

    def tail(self, n: int = 3000) -> str:
        with open(self.log) as f:
            return f.read()[-n:]

    def launches(self) -> dict:
        """The kernels' launch counts since the last `zero` (SIGUSR2; the
        child prints them)."""
        import signal
        with open(self.log) as f:
            seen = f.read().count("router child launches: ")
        self.proc.send_signal(signal.SIGUSR2)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 30:
            with open(self.log) as f:
                lines = [ln for ln in f
                         if ln.startswith("router child launches: ")]
            if len(lines) > seen:
                return json.loads(lines[-1].split(": ", 1)[1])
            time.sleep(0.05)
        fail(f"router: {self.tag} printed no launch counts:\n{self.tail()}")

    def zero(self) -> None:
        import signal
        self.proc.send_signal(signal.SIGUSR1)

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _rt_replica(tree, model_dir, dtype, tag, announce=None,
                port=None) -> tuple:
    """(process, its address): `python -c RT_CHILD` serving the paged
    engine with --auto-prefix; announce: the router's announce listener
    (the replica registers itself) or None (the router names it)."""
    port = port or _free_port()
    addr = f"127.0.0.1:{port}"
    argv = [sys.executable, "-c", RT_CHILD, tree, "--model", model_dir,
            "--dtype", dtype, "--api", addr, "--kv-pages", str(RT_PAGES),
            "--auto-prefix", "--max-slots", str(RT_SLOTS),
            "--decode-scan", "4", "--max-seq-len", str(RT_T),
            "--temperature", "0", "--repeat-penalty", "1.0",
            "--sample-len", str(RT_NEW), *(["--cpu"] if DEV == "cpu" else [])]
    if announce:
        argv += ["--router-announce", announce, "--announce-interval",
                 "0.5"]
    return _RtProc(argv, tag, tree), addr


def _rt_router(tree, model_dir, named: str, tag: str) -> tuple:
    """(process, its address, its announce address): `python -m
    cake_tpu_torch.cli --router` over `named` and whatever announces."""
    port, aport = _free_port(), _free_port()
    argv = [sys.executable, "-m", "cake_tpu_torch.cli", "--router",
            "--model", model_dir, "--api", f"127.0.0.1:{port}",
            "--replicas", named, "--router-announce",
            f"127.0.0.1:{aport}", "--announce-interval", "0.5",
            "--router-poll", "0.1"]
    return (_RtProc(argv, tag, tree), f"127.0.0.1:{port}",
            f"127.0.0.1:{aport}")


def _rt_up(router: str, replicas, procs, timeout: float = 300.0) -> float:
    """Wait on the router's state until every replica is admitting."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        for p in procs:
            if p.proc.poll() is not None:
                fail(f"router: {p.tag} died at startup:\n{p.tail()}")
        try:
            st = _mh_get(f"http://{router}/api/v1/router", 2.0)["replicas"]
            if all(st.get(r, {}).get("admitting") for r in replicas):
                return time.perf_counter() - t0
        except (OSError, ValueError):
            pass
        time.sleep(0.2)
    fail(f"router: replicas {replicas} never all admitting")


def _rt_system(tok, tag: str, n: int) -> str:
    """A tenant's system prompt of at least n tokens of the tokenizer."""
    words = ("policy", "ledger", "answer", "source", "careful", "exact",
             "region", "customer", "order", "refund", "shipping", "tone")
    text, i = f"You are the assistant of tenant {tag}.", 0
    while len(tok.encode(text, add_special_tokens=False)) < n:
        text += f" {words[i % len(words)]}"
        i += 1
    return text


def _rt_chat(addr: str, system: str, user: str, n_new: int = RT_NEW,
             headers=None, last_id=None) -> dict:
    """One SSE chat: its text, the router's and the replica's headers,
    the first content event's time, the highest event id."""
    import http.client
    body = {"messages": [{"role": "system", "content": system},
                         {"role": "user", "content": user}],
            "max_tokens": n_new, "temperature": 0.0, "stream": True}
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    if last_id is not None:
        hdrs["Last-Event-ID"] = str(last_id)
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection(addr, timeout=600)
    conn.request("POST", "/api/v1/chat/completions",
                 body=json.dumps(body).encode(), headers=hdrs)
    resp = conn.getresponse()
    if resp.status != 200:
        raise RuntimeError(f"{resp.status} {resp.read()[:300]!r}")
    out = dict(t0=t0, t_first=None, pieces=[], last_id=None,
               replica=resp.getheader("x-cake-replica"),
               rid=resp.getheader("x-cake-rid"),
               trace=resp.getheader("x-cake-trace"), resp=resp, conn=conn)
    return out


def _rt_read(c: dict, stop_after=None) -> dict:
    """Read c's SSE events (all, or the first `stop_after` content
    ones): text pieces, event ids, the first content time."""
    cur = None
    for raw in c["resp"]:
        line = raw.decode().rstrip("\n")
        if line.startswith("id: "):
            cur = int(line[4:])
        elif line.startswith("data: ") and line != "data: [DONE]":
            ev = json.loads(line[6:])
            if "error" in ev:
                c["error"] = ev["error"]
                break
            piece = ev["choices"][0]["delta"].get("content")
            if piece:
                if c["t_first"] is None:
                    c["t_first"] = time.perf_counter()
                c["pieces"].append(piece)
                c["last_id"] = cur
                if stop_after and len(c["pieces"]) >= stop_after:
                    return c
        elif line == "data: [DONE]":
            break
    c["conn"].close()
    return c


def _rt_text(c: dict) -> str:
    return "".join(c["pieces"])


def _rt_wave(addr: str, chats, tag: str, home=None) -> dict:
    """The chats (system, user) at once through `addr` (or each straight
    to home[i]): texts, replicas, TTFT p50."""
    out, errs = {}, {}

    def one(i, system, user):
        try:
            a = home[i] if home else addr
            out[i] = _rt_read(_rt_chat(a, system, user))
        except Exception as e:   # noqa: BLE001
            errs[i] = repr(e)

    threads = [threading.Thread(target=one, args=(i, s, u))
               for i, (s, u) in enumerate(chats)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errs or len(out) != len(chats):
        fail(f"router [{tag}]: chats failed {errs}")
    return dict(wall_s=time.perf_counter() - t0,
                texts=[_rt_text(out[i]) for i in range(len(chats))],
                replicas=[out[i]["replica"] for i in range(len(chats))],
                ttft_p50_s=statistics.median(
                    c["t_first"] - c["t0"] for c in out.values()))


def _rt_metric(addr: str, name: str) -> float:
    return sum(v for k, v in _mh_metrics(f"http://{addr}").items()
               if k == name or k.startswith(name + "{"))


def _rt_tenant_chats(tok, tag: str):
    """The phase's chats: RT_CHATS a tenant, each tenant's system prompt
    RT_TENANTS tokens long."""
    return [(_rt_system(tok, f"{tag}{t}", n), f"question {i} of {t}: "
             "what should I check first?")
            for t, n in enumerate(RT_TENANTS) for i in range(RT_CHATS)]


def _rt_start(tree: str) -> dict:
    """The router phase's six processes started: the f32 pair a0 (named)
    and a1 (announced) behind router_a, the bf16 pair b0 (named, and
    announcing too: either bf16 replica can be (c)'s drained home and the
    other (d)'s departing one) and b1 behind router_b."""
    d32, d16 = _rt_model_dir(RT_F32_LAYERS), _rt_model_dir(RT_LAYERS)
    st = dict(d32=d32, d16=d16)
    st["a0"], st["a0_addr"] = _rt_replica(tree, d32, "f32", "a0")
    st["ra"], st["ra_addr"], ra_ann = _rt_router(tree, d32, st["a0_addr"],
                                                 "router_a")
    st["a1"], st["a1_addr"] = _rt_replica(tree, d32, "f32", "a1", ra_ann)
    b0_port = _free_port()
    st["rb"], st["rb_addr"], rb_ann = _rt_router(
        tree, d16, f"127.0.0.1:{b0_port}", "router_b")
    st["b0"], st["b0_addr"] = _rt_replica(tree, d16, "bf16", "b0", rb_ann,
                                          port=b0_port)
    st["b1"], st["b1_addr"] = _rt_replica(tree, d16, "bf16", "b1", rb_ann)
    st["procs"] = [st[k] for k in ("a0", "ra", "a1", "b0", "rb", "b1")]
    return st


def phase_router(torch, card: str, tree: str):
    """The router phase (ROADMAP A15): `python -m cake_tpu_torch.cli
    --router` over two replica processes (the paged engine, --auto-prefix,
    Llama-3-8B width from seed 0), one named by --replicas, the other
    registered by --router-announce. (a) f32 at 2 blocks: every text
    through the router is the text straight from the replica it names
    (x-cake-replica), and every chat of a tenant lands on one replica.
    (b) bf16 at 8 blocks: twelve SSE chats, a warm wave then a measured
    one: TTFT p50 through the router beside straight to the replicas,
    prefix hits per replica, the router's cake_router_* families,
    /api/v1/fleet with both replicas, no capture in the measured wave,
    the kernels' launches in it. (c) faults: a replica SIGKILLed in the
    middle of a keyed stream, the reconnect with Last-Event-ID finishing
    on the survivor (the reference's text) and the router's federated
    timeline naming both; a drained replica gets no new admission while
    its stream finishes (the router's state awaited). (d) a SIGTERMed
    replica's departure reaches the router before the replica exits.
    Returns (the measured wave's launches, the record)."""
    from cake_tpu_torch.models.llama.generator import load_tokenizer

    t0 = time.perf_counter()
    st = _rt_start(tree)
    procs = st["procs"]
    rec: dict = {}
    try:
        a0, ra, a1, b0, rb, b1 = procs
        a0_addr, ra_addr, a1_addr = st["a0_addr"], st["ra_addr"], \
            st["a1_addr"]
        b0_addr, rb_addr, b1_addr = st["b0_addr"], st["rb_addr"], \
            st["b1_addr"]
        tok = load_tokenizer(st["d32"])
        chats = _rt_tenant_chats(tok, "t")
        rec["system_tokens"] = [
            len(tok.encode(chats[i][0], add_special_tokens=False))
            for i in range(0, len(chats), RT_CHATS)]
        rec["a_startup_s"] = _rt_up(ra_addr, (a0_addr, a1_addr),
                                    (a0, a1, ra))

        # (a) f32: through the router, then straight to the named replica
        homes: dict = {}
        for i, (system, user) in enumerate(chats):
            via = _rt_read(_rt_chat(ra_addr, system, user))
            if via["replica"] not in (a0_addr, a1_addr) or not via["trace"]:
                fail(f"router (a): chat {i} came back from "
                     f"{via['replica']!r}, trace {via['trace']!r}")
            direct = _rt_read(_rt_chat(via["replica"], system, user))
            if _rt_text(via) != _rt_text(direct):
                fail(f"router (a): chat {i}'s text through the router is "
                     f"not {via['replica']}'s own")
            homes.setdefault(i // RT_CHATS, set()).add(via["replica"])
        if any(len(h) != 1 for h in homes.values()):
            fail(f"router (a): a tenant's chats split over {homes}")
        fleet = _mh_get(f"http://{ra_addr}/api/v1/fleet", 10)
        src = {r: fleet["replicas"][r]["source"] for r in (a0_addr, a1_addr)}
        rec["a"] = dict(homes={t: sorted(h)[0] for t, h in homes.items()},
                        sources=src)
        log(f"router (a) f32 {RT_F32_LAYERS} blocks: {len(chats)} chats "
            f"of {len(RT_TENANTS)} tenants (system prompts "
            f"{rec['system_tokens']} tokens) equal their replica's own "
            f"text, each tenant on one replica {rec['a']['homes']}; "
            f"sources {src} [{card}]")

        # (c) kill: a keyed stream's home dies after 3 events
        sysk, userk = chats[0][0], "tell me everything about the policy"
        key = {"x-cake-idempotency-key": "smoke-kill"}
        c = _rt_read(_rt_chat(ra_addr, sysk, userk, RT_LONG, key),
                     stop_after=3)
        home = c["replica"]
        rid_home = c["rid"]
        survivor = a1_addr if home == a0_addr else a0_addr
        (a0 if home == a0_addr else a1).kill()
        try:
            _rt_read(c)
        except Exception:   # noqa: BLE001 — the replica is gone
            pass
        c2 = _rt_read(_rt_chat(ra_addr, sysk, userk, RT_LONG, key,
                               last_id=c["last_id"]))
        if c2["replica"] != survivor or c2["trace"] != c["trace"]:
            fail(f"router (c): the reconnect went to {c2['replica']} "
                 f"(trace {c2['trace']} vs {c['trace']})")
        ref = _rt_read(_rt_chat(survivor, sysk, userk, RT_LONG))
        if _rt_text(c) + _rt_text(c2) != _rt_text(ref):
            fail("router (c): the resumed stream's text is not the "
                 "reference's")
        tl = _mh_get(f"http://{ra_addr}/api/v1/requests/{c2['rid']}"
                     "/timeline", 30)
        rows = {r["replica"]: r for r in tl["replicas"]}
        if set(rows) != {home, survivor} or tl["trace"] != c["trace"] \
                or str(rows[home]["rid"]) != str(rid_home):
            fail(f"router (c): the federated timeline names {rows}")
        rec["c_kill"] = dict(events_before=len(c["pieces"]),
                             resumed_on=survivor, timeline_entries=len(
                                 tl["timeline"]),
                             causes=tl["summary"]["causes"])
        log(f"router (c) kill: {home} SIGKILLed after "
            f"{len(c['pieces'])} events; the keyed reconnect (Last-Event-ID "
            f"{c['last_id']}) finished on {survivor}, the reference's text; "
            f"the federated timeline names both ({len(tl['timeline'])} "
            f"entries, causes {tl['summary']['causes']}) [{card}]")
        for p in (a0, a1, ra):
            p.kill()
        parts = {"a_c_kill": time.perf_counter() - t0}

        # (b) bf16 at 8 blocks: a warm wave, then the measured one
        rec["b_startup_s"] = _rt_up(rb_addr, (b0_addr, b1_addr),
                                    (b0, b1, rb))
        chats16 = _rt_tenant_chats(tok, "u")

        def captures():
            return [_rt_metric(r, "cake_jit_compiles_total")
                    for r in (b0_addr, b1_addr)]

        # warm until a wave captures nothing (at most 4 waves): which
        # step variants a wave needs follows the chats' arrival order
        caps0 = captures()
        for warm in range(1, 5):
            _rt_wave(rb_addr, chats16, "warm")
            got = captures()
            if got == caps0:
                break
            caps0 = got
        rec["warm_waves"] = warm
        for p in (b0, b1):
            p.zero()
        time.sleep(1.0)      # the zeroing lands between the waves
        via = _rt_wave(rb_addr, chats16, "measured")
        launches: dict = {}
        for p in (b0, b1):
            for k, n in p.launches().items():
                launches[k] = launches.get(k, 0) + n
        caps = [_rt_metric(r, "cake_jit_compiles_total") - c0
                for r, c0 in zip((b0_addr, b1_addr), caps0)]
        direct = _rt_wave(None, chats16, "direct", home=via["replicas"])
        # printed, not gated: at bf16 a wave's batch composition moves
        # near-ties ((a) holds the texts at f32)
        same = sum(a == b for a, b in zip(direct["texts"], via["texts"]))
        if any(caps):
            fail(f"router (b): the measured wave captured {caps} graphs")
        for k in ("rpa_decode", "rpa_mixed"):
            if launches.get(k, 0) <= 0 and DEV == "cuda":
                fail(f"router (b): {k} never launched on the replicas "
                     f"({launches})")
        plain = {k: n for k, n in launches.items()
                 if k.endswith("_plain") and n}
        if plain and DEV == "cuda":
            fail(f"router (b): plain versions ran {plain}")
        hits = {r: _rt_metric(r, "cake_engine_prefix_hits_total")
                for r in (b0_addr, b1_addr)}
        m = _mh_metrics(f"http://{rb_addr}")
        rmet = {k: v for k, v in m.items() if k.startswith("cake_router_")}
        fleet = _mh_get(f"http://{rb_addr}/api/v1/fleet", 10)
        if set(fleet["replicas"]) != {b0_addr, b1_addr}:
            fail(f"router (b): /api/v1/fleet shows {fleet['replicas']}")
        if not any(k.startswith("cake_router_requests_total") for k in rmet):
            fail("router (b): no cake_router_requests_total on /metrics")
        rec["b"] = dict(
            router=dict(ttft_p50_s=via["ttft_p50_s"], wall_s=via["wall_s"]),
            direct=dict(ttft_p50_s=direct["ttft_p50_s"],
                        wall_s=direct["wall_s"]),
            replicas=Counter(via["replicas"]), prefix_hits=hits,
            texts_equal_direct=same,
            measured_captures=caps, launches=launches,
            fleet={r: v.get("source") for r, v in fleet["replicas"].items()},
            router_families=sorted({k.split("{")[0] for k in rmet}))
        log(f"router (b) bf16 {RT_LAYERS} blocks: {len(chats16)} SSE chats, "
            f"TTFT p50 {via['ttft_p50_s']:.3f} s through the router, "
            f"{direct['ttft_p50_s']:.3f} s straight to the replicas ({same} "
            f"of {len(chats16)} bf16 texts equal); "
            f"replicas {dict(Counter(via['replicas']))}, prefix hits {hits}, "
            f"the measured wave's captures {caps}, launches {launches}; "
            f"router families {rec['b']['router_families']} [{card}]")
        parts["b"] = time.perf_counter() - t0

        # (c) drain: b0 drains while its stream runs; new work goes to b1
        c = _rt_read(_rt_chat(rb_addr, chats16[0][0], "a long answer",
                              RT_LONG), stop_after=1)
        home = c["replica"]
        other = b1_addr if home == b0_addr else b0_addr
        code, st = _http_json(f"http://{home}/api/v1/drain",
                              {"timeout_s": 120})
        if code != 200 or not st.get("draining"):
            fail(f"router (c) drain: {code} {st}")
        t_drain = time.perf_counter()
        while time.perf_counter() - t_drain < 60:
            rows = _mh_get(f"http://{rb_addr}/api/v1/router", 5)["replicas"]
            if not rows[home]["admitting"]:
                break
            time.sleep(0.05)
        else:
            fail(f"router (c) drain: the router still admits to {home}")
        seen_s = time.perf_counter() - t_drain
        after = [_rt_read(_rt_chat(rb_addr, chats16[0][0], f"after {i}"))
                 for i in range(3)]
        if {x["replica"] for x in after} != {other}:
            fail(f"router (c) drain: new chats went to "
                 f"{[x['replica'] for x in after]}")
        _rt_read(c)
        if len(c["pieces"]) < 2 or "error" in c:
            fail(f"router (c) drain: the in-flight stream ended with "
                 f"{len(c['pieces'])} events {c.get('error')}")
        rec["c_drain"] = dict(router_saw_s=seen_s, stream_events=len(
            c["pieces"]), after=other)
        log(f"router (c) drain: the router stopped admitting to {home} "
            f"{seen_s:.3f} s after its drain; 3 new chats went to {other}, "
            f"the in-flight stream finished ({len(c['pieces'])} events) "
            f"[{card}]")

        # (d) SIGTERM the announced replica: its departure first
        import signal
        dep = b1 if other == b1_addr else b0
        dep_addr = other
        exited = []

        def wait_exit():
            dep.proc.wait(120)
            exited.append(time.time())

        w = threading.Thread(target=wait_exit)
        dep.proc.send_signal(signal.SIGTERM)
        w.start()
        t_dep = None
        while time.perf_counter() - t_drain < 300 and t_dep is None:
            evs = _mh_get(f"http://{rb_addr}/api/v1/events?type="
                          "replica_departed", 5)["events"]
            for ev in evs:
                if ev.get("replica") == dep_addr:
                    t_dep = ev["ts"]
            time.sleep(0.05)
        w.join(timeout=120)
        if t_dep is None or not exited or not t_dep < exited[0]:
            fail(f"router (d): departure at {t_dep}, exit at {exited} "
                 f"for {dep_addr}:\n{dep.tail()}")
        rec["d"] = dict(departed_before_exit_s=exited[0] - t_dep,
                        rc=dep.proc.returncode)
        log(f"router (d): {dep_addr} SIGTERMed: the router's "
            f"replica_departed {exited[0] - t_dep:.3f} s before the "
            f"process exited ({dep.proc.returncode}) [{card}]")
        parts["c_d"] = time.perf_counter() - t0
        rec["part_ends_s"] = parts
    finally:
        for p in procs:
            p.kill()
    rec["seconds"] = time.perf_counter() - t0
    log(f"router phase: {rec['seconds']:.1f} s")
    return rec["b"]["launches"], rec



# -- phase: native (the host runtime, ROADMAP A16) ----------------------------

# the scheduler drive's seeded ops; the reader's checkpoint: Llama-3-8B's
# width at NATIVE_LAYERS blocks, bf16
NATIVE_OPS = 10000
NATIVE_LAYERS = 2
# what the other phases leave for the native phase's end: the schedulers
# their engines ran, the checkpoint command line's reader and directory,
# the recovery phase's journal, the children's logs
_NATIVE: dict = {"schedulers": Counter(), "child_logs": []}


def _note_fifo(engine, where: str) -> None:
    """A FIFO-scheduled engine of the served path must run the native
    scheduler (a tree without one is let through: a parent's run)."""
    import importlib
    mod = importlib.import_module("cake_tpu_torch.native.scheduler")
    kind = type(engine.scheduler).__name__
    _NATIVE["schedulers"][kind] += 1
    if hasattr(mod, "NativeScheduler") and kind != "NativeScheduler":
        fail(f"{where}: the engine runs {kind}, not NativeScheduler")


def _native_sched_ops(seed: int, n: int):
    """A seeded op sequence over a 8-slot FIFO with a 64-deep queue:
    submits (a duplicate now and then; a full queue comes on its own),
    cancels of queued and active requests, plans, reports with EOS and
    past max-tokens."""
    import random
    rng = random.Random(seed)
    ops, next_rid, known = [], 1, []
    for _ in range(n):
        op = rng.choice(["submit", "submit", "plan", "plan", "report",
                         "report", "report", "cancel"])
        if op == "submit":
            rid = next_rid if rng.random() < 0.9 or not known \
                else rng.choice(known)
            if rid == next_rid:
                next_rid += 1
                known.append(rid)
            ops.append((op, (rid, rng.randint(1, 4000),
                             rng.randint(1, 12))))
        elif op == "cancel":
            ops.append((op, (rng.choice(known) if known else 1,)))
        elif op == "report":
            ops.append((op, (None, rng.randint(1, 4), rng.random() < 0.1)))
        else:
            ops.append((op, ()))
    return ops


def _native_sched_drive(sched, ops) -> tuple:
    """(the results and counters of each op, seconds inside plan(), the
    plans); a report goes to a request of the last plan."""
    out, plan_s, plans, active = [], 0.0, 0, []
    for i, (op, args) in enumerate(ops):
        if op == "plan":
            t0 = time.perf_counter()
            got = sched.plan()
            plan_s += time.perf_counter() - t0
            plans += 1
            active = [rid for rid, _ in got[0] + got[1]]
        elif op == "report":
            rid = active[i % len(active)] if active else 10 ** 9
            got = sched.report(rid, *args[1:])
        else:
            got = getattr(sched, op)(*args)
        out.append((got, sched.queue_depth, sched.active, sched.completed))
    return out, plan_s, plans


def phase_native_start(torch, card: str) -> dict:
    """(a) the two libraries built, (b) the schedulers against each
    other. Returns the record the phase's end completes."""
    import cake_tpu_torch.native as native
    from cake_tpu_torch.native.embed import build_embed_library
    from cake_tpu_torch.native.scheduler import NativeScheduler, PyScheduler

    lib = native.get_library()
    if lib is None:
        fail("native: libcake_native did not build or load (the Python "
             "fallbacks would serve instead)")
    info = dict(native.BUILD_INFO)
    if os.path.dirname(info["path"]) != native.BUILD_DIR:
        fail(f"native: the library came from {info['path']}")
    t0 = time.perf_counter()
    embed_path = build_embed_library()
    embed_s = time.perf_counter() - t0
    log(f"native (a): libcake_native built and loaded in "
        f"{info['seconds']:.2f} s ({os.path.basename(info['path'])}), "
        f"libcake_embed in {embed_s:.2f} s "
        f"({os.path.basename(embed_path)}) [{card}]")
    ops = _native_sched_ops(26, NATIVE_OPS)
    got, nat_s, n_plans = _native_sched_drive(NativeScheduler(8, 64), ops)
    want, py_s, _ = _native_sched_drive(PyScheduler(8, 64), ops)
    if got != want:
        k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        fail(f"native (b): op {k} ({ops[k]}) gives {got[k]} natively, "
             f"{want[k]} in Python")
    kinds = Counter(op for op, _ in ops)
    refused = sum(1 for (op, _), r in zip(ops, want)
                  if op == "submit" and r[0] is False)
    retired = want[-1][3]
    if not refused or not retired:
        fail(f"native (b): the sequence refused {refused} submits and "
             f"retired {retired} requests")
    rec = dict(build_s=info["seconds"], embed_build_s=embed_s,
               sched_ops=dict(kinds), sched_refused=refused,
               sched_retired=retired, plans=n_plans,
               plan_us_native=1e6 * nat_s / n_plans,
               plan_us_python=1e6 * py_s / n_plans,
               embed_lib=embed_path)
    log(f"native (b): {NATIVE_OPS} ops ({dict(kinds)}), {refused} refused "
        f"submits, {retired} retired: the same plans and counters; plan() "
        f"{rec['plan_us_native']:.2f} us native, "
        f"{rec['plan_us_python']:.2f} us Python [{card}]")
    return rec


def _native_checkpoint(torch, d: str):
    """Write the reader's checkpoint: NATIVE_LAYERS blocks at Llama-3-8B
    width, bf16, drawn on the card from seed 0 (config.json beside)."""
    import dataclasses

    from cake_tpu_torch.models.llama.config import LlamaConfig
    from cake_tpu_torch.models.llama.params import hf_param_layout
    from cake_tpu_torch.utils.loading import save_safetensors

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_hidden_layers=NATIVE_LAYERS)
    layout, per_layer, L = hf_param_layout(cfg)
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    shapes = {"input_layernorm.weight": (D,),
              "post_attention_layernorm.weight": (D,),
              "self_attn.q_proj.weight": (H * hd, D),
              "self_attn.k_proj.weight": (KV * hd, D),
              "self_attn.v_proj.weight": (KV * hd, D),
              "self_attn.o_proj.weight": (D, H * hd),
              "mlp.gate_proj.weight": (F, D), "mlp.up_proj.weight": (F, D),
              "mlp.down_proj.weight": (D, F),
              "model.embed_tokens.weight": (V, D),
              "model.norm.weight": (D,), "lm_head.weight": (V, D)}
    names = [n for n, _ in layout.values()] + [
        f"model.layers.{i}.{sfx}" for i in range(L)
        for sfx, _ in per_layer.values()]
    g = torch.Generator(device=DEV).manual_seed(0)
    tensors = {}
    for n in names:
        key = n.split(".", 3)[-1] if n.startswith("model.layers.") else n
        tensors[n] = (torch.randn(shapes[key], generator=g, device=DEV,
                                  dtype=torch.bfloat16) * 0.02).cpu()
    save_safetensors(os.path.join(d, "model.safetensors"), tensors)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"hidden_size": D, "intermediate_size": F,
                   "num_hidden_layers": L, "num_attention_heads": H,
                   "num_key_value_heads": KV, "vocab_size": V,
                   "rms_norm_eps": cfg.rms_norm_eps,
                   "rope_theta": cfg.rope_theta,
                   "max_position_embeddings": cfg.max_position_embeddings,
                   "bos_token_id": cfg.bos_token_id,
                   "eos_token_id": list(cfg.eos_token_ids)}, f)
    return cfg, sum(t.numel() * 2 for t in tensors.values())


def _native_embed_host(rec: dict, tree: str, card: str) -> None:
    """(e) examples/embed_host/main.c built against libcake_embed, run in
    a fresh process: 8 tokens from the generate phase's checkpoint (one
    written here when that phase did not run)."""
    import shutil
    import sysconfig
    import tempfile

    tmp = tempfile.mkdtemp(prefix="cake_smoke_embed_")
    model = _NATIVE.get("ckpt_dir")
    if model is None:
        model = os.path.join(tmp, "ckpt")
        os.makedirs(model)
        _write_checkpoint(model)
    base = os.path.join(tmp, "node")
    os.makedirs(base)
    os.symlink(model, os.path.join(base, "model"))
    exe = os.path.join(tmp, "embed_host")
    lib = rec["embed_lib"]
    t0 = time.perf_counter()
    cc = shutil.which("gcc") or "cc"
    r = subprocess.run(
        [cc, "-O2", "-o", exe,
         os.path.join(tree, "examples", "embed_host", "main.c"), lib,
         f"-Wl,-rpath,{os.path.dirname(lib)}",
         f"-Wl,-rpath,{sysconfig.get_config_var('LIBDIR')}"],
        capture_output=True, text=True)
    if r.returncode != 0:
        fail(f"native (e): the embed host did not build:\n{r.stderr}")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [tree] + [p for p in sys.path if p.endswith("-packages")]))
    r = subprocess.run([exe, base, "--prompt", "Why is the sky blue?",
                        "--n", "8"], env=env, capture_output=True,
                       text=True, timeout=300)
    wall = time.perf_counter() - t0
    out = r.stdout.strip().splitlines()
    if r.returncode != 0 or "embed_host: done" not in r.stdout:
        fail(f"native (e): the embed host exited {r.returncode}:\n"
             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    rec.update(embed_host_s=wall, embed_host_text=out[-2] if len(out) > 1
               else "")
    log(f"native (e): the C embed host (examples/embed_host/main.c) "
        f"generated {rec['embed_host_text']!r} from {model} in a fresh "
        f"process, {wall:.1f} s with its build [{card}]")


def _native_tools(rec: dict, tree: str, card: str) -> None:
    """(f) the host-only tools, on a machine with no jax."""
    r = subprocess.run([sys.executable, "-m", "cake_tpu_torch.tools.cakelint",
                        "cake_tpu_torch/", "--json"], cwd=tree,
                       capture_output=True, text=True, timeout=300)
    try:
        lint = json.loads(r.stdout)
    except ValueError:
        fail(f"native (f): cakelint printed no report:\n{r.stderr[-2000:]}")
    if r.returncode != 0 or lint["findings"] or not all(
            lint["sites"].get(k, 0) > 0 for k in (
                "affinity", "guards", "locks", "capture-purity")):
        fail(f"native (f): cakelint exit {r.returncode}, sites "
             f"{lint['sites']}, findings {lint['findings'][:3]}")
    rec.update(cakelint_sites=lint["sites"],
               cakelint_suppressed=lint["suppressed"])
    jpath = _NATIVE.get("journal")
    if jpath is None:
        log("native (f): no recovery journal (the recovery phase did not "
            "run): journal_check not driven")
    else:
        r = subprocess.run([sys.executable, "-m",
                            "cake_tpu_torch.tools.journal_check", jpath,
                            "--json"], cwd=tree, capture_output=True,
                           text=True, timeout=120)
        try:
            doc = json.loads(r.stdout)
        except ValueError:
            fail(f"native (f): journal_check printed no document "
                 f"(exit {r.returncode}):\n{r.stderr[-2000:]}")
        if r.returncode != 0 or doc["rc"] != 0 or not doc["requests"]:
            fail(f"native (f): journal_check exit {r.returncode} on "
                 f"{jpath}: findings {doc['findings'][:5]}")
        rec.update(journal_records=doc["records"],
                   journal_requests=len(doc["requests"]),
                   journal_torn_tail=doc["torn_tail"])
    journal = (f"exit 0, {rec['journal_requests']} requests in "
               f"{rec['journal_records']} records" if jpath
               else "not driven")
    log(f"native (f): cakelint exit 0 on cake_tpu_torch/ (sites "
        f"{lint['sites']}, {lint['suppressed']} suppressed); journal_check "
        f"{journal} [{card}]")


def _native_loads(torch, rec: dict, cfg, d: str, card: str) -> None:
    """(c) the checkpoint through load_params_from_hf with the native
    reader, then with the numpy memmap: equal tensors on the card."""
    import cake_tpu_torch.native.safetensors as nst
    from cake_tpu_torch.models.llama.params import load_params_from_hf

    def load():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = load_params_from_hf(d, cfg, dtype=torch.bfloat16, device=DEV)
        torch.cuda.synchronize()
        return p, time.perf_counter() - t0

    opened = []
    real_open = nst.StFile
    nst.StFile = lambda path: opened.append(path) or real_open(path)
    try:
        native_p, native_s = load()
    finally:
        nst.StFile = real_open
    if len(opened) != 1:
        fail(f"native (c): the native reader opened {opened}")
    real_lib = nst.get_library
    nst.get_library = lambda: None
    try:
        memmap_p, memmap_s = load()
    finally:
        nst.get_library = real_lib
    a = torch.utils._pytree.tree_flatten(native_p)[0]
    b = torch.utils._pytree.tree_flatten(memmap_p)[0]
    if len(a) != len(b) or not a or not all(
            x.device.type == torch.device(DEV).type and torch.equal(x, y)
            for x, y in zip(a, b)):
        fail("native (c): the two readers' tensors differ on the card")
    rec.update(load_native_s=native_s, load_memmap_s=memmap_s,
               load_tensors=len(a))
    log(f"native (c): load_params_from_hf of {rec['ckpt_gb']:.2f} GB "
        f"({NATIVE_LAYERS} Llama-3-8B-width blocks, bf16; page cache warm) "
        f"{native_s:.2f} s through the native reader, {memmap_s:.2f} s "
        f"through the numpy memmap; {len(a)} equal tensors on the card "
        f"[{card}]")
    del native_p, memmap_p, a, b
    torch.cuda.empty_cache()


def phase_native_end(torch, rec: dict, card: str, tree: str) -> dict:
    """(d)-(f), and (c) beside them: see the module docstring."""
    import shutil
    import tempfile

    scheds = dict(_NATIVE["schedulers"])
    if scheds and set(scheds) != {"NativeScheduler"}:
        fail(f"native (d): the served FIFO engines ran {scheds}")
    reader = _NATIVE.get("ckpt_reader")
    if reader is not None and reader != "native reader":
        fail(f"native (d): the checkpoint command line read through the "
             f"{reader}")
    rec.update(served_schedulers=scheds, checkpoint_cli_reader=reader)
    log(f"native (d): served FIFO engines {scheds or 'none ran'}; the "
        f"checkpoint command line read through the "
        f"{reader or '(generate did not run)'} [{card}]")
    d = tempfile.mkdtemp(prefix="cake_smoke_native_ckpt_")
    box = {}

    def write():
        try:
            box["out"] = _native_checkpoint(torch, d)
        except BaseException as e:   # re-raised by the join below
            box["error"] = e

    writer = threading.Thread(target=write, daemon=True)
    t0 = time.perf_counter()
    writer.start()
    _native_embed_host(rec, tree, card)
    _native_tools(rec, tree, card)
    writer.join()
    if "error" in box:
        raise box["error"]
    cfg, nbytes = box["out"]
    rec.update(ckpt_gb=nbytes / 1e9,
               ckpt_write_s=time.perf_counter() - t0)
    _native_loads(torch, rec, cfg, d, card)
    shutil.rmtree(d, ignore_errors=True)
    return rec


def _affinity_violations() -> list:
    """WrongThreadErrors of this process and of every child's log (a
    parent tree without the asserts has only the logs to read)."""
    annotations = sys.modules.get("cake_tpu_torch.analysis.annotations")
    bad = list(getattr(annotations, "VIOLATIONS", []))
    for path in _NATIVE["child_logs"]:
        try:
            with open(path, errors="replace") as f:
                if "WrongThreadError" in f.read():
                    bad.append(f"WrongThreadError in {path}")
        except OSError:
            pass
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list out of {PHASES}")
    ap.add_argument("--profile", action="store_true",
                    help="trace generate run A and run B's prefill, and the "
                         "prefix phase's drives, with torch.profiler and "
                         "print where the device time went (the serve phase "
                         "always profiles its third drive)")
    ap.add_argument("--kernels", default="",
                    help="comma list of kernel names: the kernels phase "
                         "runs only these (a parent-against-change aid)")
    ap.add_argument("--tree", default="",
                    help="import cake_tpu_torch from this directory (for "
                         "example a parent commit unpacked with git "
                         "archive) instead of the one beside this script")
    ap.add_argument("--int4-sweep", default="",
                    help="comma list of cluster sizes (ranges of the group "
                         "axis): time int4_matmul at each and exit (a "
                         "tuning aid, not part of the smoke)")
    a = ap.parse_args(argv)
    phases = [p for p in a.phases.split(",") if p]
    bad = set(phases) - set(PHASES)
    if bad:
        fail(f"unknown phases {sorted(bad)}")

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "an NVIDIA card")
    # the engine-thread asserts armed as in tier-1, before the port is
    # imported (the decorator reads the flag once); children inherit it
    os.environ["CAKE_THREAD_ASSERTS"] = "1"
    tree = os.path.abspath(a.tree) if a.tree else \
        os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, tree)
    log(f"cake_tpu_torch from {tree}")
    try:
        import cake_tpu_torch.ops.flash_attention as fa
        import cake_tpu_torch.ops.int4_matmul as i4
        import cake_tpu_torch.ops.ragged_paged_attention as rpa
    except ImportError as e:
        fail(f"cake_tpu_torch is not importable next to this script "
             f"({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if a.int4_sweep:
        log(phase_device(torch, i4))
        int4_sweep(torch, i4, [int(t) for t in a.int4_sweep.split(",")])
        return 0
    t_start = time.perf_counter()

    def lap(name: str) -> None:
        """The smoke's clock at the end of a phase (the whole smoke has a
        time budget: each phase's share shows where it goes)."""
        log(f"smoke clock: {name} done at "
            f"{time.perf_counter() - t_start:.1f} s")

    card = phase_device(torch, rpa, fa, i4)
    lap("device")
    native_record = None
    if "native" in phases and importlib.util.find_spec(
            "cake_tpu_torch.native.embed"):
        native_record = phase_native_start(torch, card)
        lap("native (a)-(b)")
    only = set(a.kernels.split(",")) - {""} or None
    kern = (phase_kernels(torch, rpa, fa, i4, only) if "kernels" in phases
            else {})
    lap("kernels")
    if "step" in phases:
        phase_step(torch, rpa, fa, i4)
    # the captured decode step and --decode-scan exist in this tree (a
    # parent tree without them serves at decode_scan 1 only)
    graphs = importlib.util.find_spec("cake_tpu_torch.serve.graphs")
    scans = (1, 4) if graphs else (1,)
    # and the captured mixed step (a parent tree may have only the decode
    # step's)
    mixed_graph = graphs is not None and hasattr(
        importlib.import_module("cake_tpu_torch.serve.graphs"),
        "MixedRunner")
    # launch counts of each path, read right after it ran (null in the
    # kernels line, not 0, when its phase did not run)
    counts = {}
    serve_records = []
    prefix_records = []
    sched_record = None
    tiers_record = None
    recovery_record = None
    spec_record = None
    spec_counts = {}
    control_record = None
    control_counts = {}
    disagg_record = None
    disagg_counts = {}
    dense_record = None
    dense_counts = {}
    moe_record = None
    moe_counts = {}
    sd_record = None
    parallel_record = None
    parallel_counts = {}
    sp_record = None
    sp_counts = {}
    mh_record = None
    mh_counts = {}
    router_record = None
    router_counts = {}
    if {"step", "generate", "serve", "prefix", "sched", "tiers",
            "recovery", "spec", "control", "disagg", "dense"} & set(phases):
        cfg, params = _big_params(torch)
        if "step" in phases and graphs:
            _graph_steps(torch, rpa, i4, cfg, params)
            if mixed_graph:
                _mixed_graph_steps(torch, rpa, i4, cfg, params)
        lap("step")
        if "generate" in phases:
            counts.update(phase_generate(torch, fa, cfg, params,
                                         profile=a.profile))
        lap("generate")
        if "serve" in phases:
            pools = {}
            runs = [(None, k) for k in scans] + [
                (kv, scans[-1]) for kv in ("int8", "int4")]
            for kv, k in runs:
                got, pools[kv or "bf16"], recs = phase_serve(
                    torch, rpa, *_cut_draft(cfg, params, CUT_LAYERS),
                    kv_dtype=kv, decode_scan=k,
                    drives=SERVE_DRIVES if kv is None else ("cold", "warm"))
                counts.update(got)
                serve_records += recs
            log(f"serve pools (128 pages x 128 tokens + the sink, "
                f"{CUT_LAYERS} layers): "
                + ", ".join(f"{k} {v:.3f} GiB" for k, v in pools.items()))
            lap("serve")
        if "prefix" in phases:
            # the flash kernels' launches on the serve path join the
            # generator's in the kernels line
            served, prefix_records = phase_prefix(
                torch, rpa, fa, *_cut_draft(cfg, params, CUT_LAYERS), card,
                a.profile)
            for k, n in served.items():
                counts[k] = counts.get(k, 0) + n
            lap("prefix")
        if "sched" in phases:
            # the scheduling drive's decode and mixed launches join the
            # serve phase's in the kernels line
            got, sched_record = phase_sched(torch, rpa, cfg, params, card)
            for k, n in got.items():
                counts[k] = counts.get(k, 0) + n
            lap("sched")
        if "tiers" in phases:
            # the fp8 kernels' launches on drive 1 (set to 0 just before)
            got, tiers_record = phase_tiers(
                torch, rpa, *_cut_draft(cfg, params, CUT_LAYERS), card)
            counts.update(got)
            lap("tiers")
        if "recovery" in phases:
            # the faulted wave's decode and mixed launches (set to 0 just
            # before it) join the serve phase's in the kernels line
            got, recovery_record = phase_recovery(
                torch, rpa, *_cut_draft(cfg, params, CUT_LAYERS), card)
            for k, n in got.items():
                counts[k] = counts.get(k, 0) + n
            lap("recovery")
        has_spec = importlib.util.find_spec("cake_tpu_torch.spec")
        if "spec" in phases and has_spec:
            # the measured self-draft wave's launches (set to 0 just
            # before it), a kernels-line key of their own
            spec_counts, spec_record = phase_spec(
                torch, rpa, fa, i4, *_cut_draft(cfg, params, CUT_LAYERS),
                card)
            lap("spec")
        has_control = importlib.util.find_spec(
            "cake_tpu_torch.autotune.space")
        if "control" in phases and has_control:
            # (1)'s measured waves' launches (set to 0 just before them),
            # a kernels-line key of their own
            control_counts, control_record = phase_control(
                torch, rpa, fa, cfg, params, card)
            lap("control")
        has_disagg = importlib.util.find_spec("cake_tpu_torch.kv.transfer")
        if "disagg" in phases and has_disagg:
            # (b)'s measured pair waves' launches (set to 0 just before
            # each), a kernels-line key of their own
            disagg_counts, disagg_record = phase_disagg(
                torch, rpa, *_cut_draft(cfg, params, CUT_LAYERS), card)
            lap("disagg")
        has_dense = graphs is not None and hasattr(
            importlib.import_module("cake_tpu_torch.serve.graphs"),
            "DenseSpecRunner")
        if "dense" in phases and has_dense:
            # (b)'s measured dense wave's launches (set to 0 just before
            # it), a kernels-line key of their own; the generate phase's
            # command lines run during (a)'s identity drives
            cli_done = _generate_cli() if "generate" in phases else None
            dense_counts, dense_record = phase_dense(
                torch, rpa, fa, i4, *_cut_draft(cfg, params, CUT_LAYERS),
                card, after_identity=cli_done)
            lap("dense")
        elif "generate" in phases:
            _generate_cli()()
        # the weight-quantized path, after the bf16 tree is dropped
        del params
        torch.cuda.empty_cache()
        q4 = None
        if "generate" in phases:
            q4, got = phase_generate_quant(torch, i4, cfg)
            counts["int4_matmul"] = got["int4_matmul"]
        if q4 is None and ("serve" in phases or "spec" in phases
                           or ("step" in phases and graphs)):
            from cake_tpu_torch.models.llama.params import (
                init_params_quantized,
            )
            q4 = init_params_quantized(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                device="cuda", dtype=torch.bfloat16, bits=4)
        if "step" in phases and graphs:
            _graph_steps(torch, rpa, i4, cfg, q4, int4_weights=True)
            if mixed_graph:
                _mixed_graph_steps(torch, rpa, i4, cfg, q4,
                                   int4_weights=True)
        if "serve" in phases:
            got, _, recs = phase_serve(torch, rpa, cfg, q4, i4=i4,
                                       decode_scan=scans[-1],
                                       drives=("cold", "warm"))
            serve_records += recs
            # the ragged kernels' counts stay those of the bf16-weight run
            counts["int4_matmul"] = (counts.get("int4_matmul", 0)
                                     + got["int4_matmul"])
        if "spec" in phases and has_spec:
            spec_record["int4"] = _spec_int4(torch, i4, cfg, q4, card)
            spec_counts["int4_matmul"] = spec_record["int4"]["int4_matmul"]
    lap("the weight-quantized runs")
    if "moe" in phases and importlib.util.find_spec(
            "cake_tpu_torch.models.moe"):
        # (b)'s measured waves' launches (set to 0 just before each),
        # a kernels-line key of their own
        moe_counts, moe_record = phase_moe(torch, rpa, fa, card)
        lap("moe")
    if "sd" in phases and importlib.util.find_spec(
            "cake_tpu_torch.models.sd"):
        sd_record = phase_sd(torch, card, tree)
        lap("sd")
    if "parallel" in phases and importlib.util.find_spec(
            "cake_tpu_torch.parallel"):
        # (a)'s measured sharded wave's flash launches and (b)'s int4
        # drive's (each set to 0 just before), a kernels-line key of
        # their own
        parallel_counts, parallel_record = phase_parallel(
            torch, fa, i4, card, tree)
        parallel_counts["int4_matmul"] = parallel_record["generators"][
            "int4_launches"]["int4_matmul"]
        lap("parallel")
    if "sp" in phases and importlib.util.find_spec(
            "cake_tpu_torch.parallel.context_parallel"):
        # (b)'s int4 drive's launches (set to 0 just before it), a
        # kernels-line key of their own
        sp_counts, sp_record = phase_sp(torch, i4, card)
        lap("sp")
    if "multihost" in phases and importlib.util.find_spec(
            "cake_tpu_torch.serve.control"):
        # the pairs' processes' launches (each process starts at 0), a
        # kernels-line key of their own
        mh_counts, mh_record = phase_multihost(torch, fa, i4, card, tree)
        lap("multihost")
    if "router" in phases and importlib.util.find_spec(
            "cake_tpu_torch.router"):
        # the measured wave's launches on both replicas (each set to 0
        # just before it), a kernels-line key of their own
        router_counts, router_record = phase_router(torch, card, tree)
        lap("router")
    if native_record is not None:
        phase_native_end(torch, native_record, card, tree)
        lap("native (c)-(f)")
    bad = _affinity_violations()
    if bad:
        fail(f"engine-thread asserts: {bad[:5]}")
    for r in serve_records:
        busy = "-" if r["busy"] is None else f"{100 * r['busy']:.1f}%"
        log(f"serve summary: {r['label']:<52} {r['run']:<8} decode "
            f"{r['decode_tok_s']:8.1f} tok/s  TTFT p50 {r['ttft_p50_s']:.3f} s"
            f"  wall {r['wall_s']:6.2f} s  busy {busy}")
    if serve_records:
        print(json.dumps({"serve": serve_records}), flush=True)
    if prefix_records:
        print(json.dumps({"prefix": prefix_records, "card": card}),
              flush=True)
    if sched_record is not None:
        print(json.dumps({"sched": sched_record, "card": card}),
              flush=True)
    if tiers_record is not None:
        print(json.dumps({"tiers": tiers_record, "card": card}),
              flush=True)
    if recovery_record is not None:
        print(json.dumps({"recovery": recovery_record, "card": card}),
              flush=True)
    if spec_record is not None:
        print(json.dumps({"spec": spec_record, "card": card}), flush=True)
    if control_record is not None:
        print(json.dumps({"control": control_record, "card": card},
                         default=str), flush=True)
    if disagg_record is not None:
        print(json.dumps({"disagg": disagg_record, "card": card},
                         default=str), flush=True)
    if dense_record is not None:
        print(json.dumps({"dense": dense_record, "card": card},
                         default=str), flush=True)
    if moe_record is not None:
        print(json.dumps({"moe": moe_record, "card": card}, default=str),
              flush=True)
    if sd_record is not None:
        print(json.dumps({"sd": sd_record, "card": card}, default=str),
              flush=True)
    if parallel_record is not None:
        print(json.dumps({"parallel": parallel_record, "card": card},
                         default=str), flush=True)
    if sp_record is not None:
        print(json.dumps({"sp": sp_record, "card": card}, default=str),
              flush=True)
    if mh_record is not None:
        print(json.dumps({"multihost": mh_record, "card": card},
                         default=str), flush=True)
    if router_record is not None:
        print(json.dumps({"router": router_record, "card": card},
                         default=str), flush=True)
    if native_record is not None:
        print(json.dumps({"native": native_record, "card": card},
                         default=str), flush=True)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        rec = kern.get((name, "bfloat16"), {})
        f32 = kern.get((name, "float32"), {})
        extra = {}
        if name == "int4_matmul":
            # the top-level numbers are M = 1's; M = 8 and 64 ride beside
            rec = kern.get((name, "bfloat16", 1), {})
            f32 = kern.get((name, "float32", 1), {})
            extra = {f"m{m}": {
                k: kern.get((name, "bfloat16", m), {}).get(k)
                for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms", "max_abs_err")}
                for m in INT4_MS[1:]}
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts.get(name),
            "spec_launches": spec_counts.get(name) if spec_record else None,
            "control_launches": (control_counts.get(name, 0)
                                 if control_record else None),
            "disagg_launches": (disagg_counts.get(name, 0)
                                if disagg_record else None),
            "dense_launches": (dense_counts.get(name, 0)
                               if dense_record else None),
            "moe_launches": (moe_counts.get(name, 0)
                             if moe_record else None),
            "parallel_launches": (parallel_counts.get(name, 0)
                                  if parallel_record else None),
            "sp_launches": (sp_counts.get(name, 0)
                            if sp_record else None),
            "multihost_launches": (mh_counts.get(name, 0)
                                   if mh_record else None),
            "router_launches": (router_counts.get(name, 0)
                                if router_record else None),
            "max_abs_err": rec.get("max_abs_err"),
            "max_abs_err_f32": f32.get("max_abs_err"),
            "ms": rec.get("ms"), "plain_ms": rec.get("plain_ms"),
            "bound_ms": rec.get("bound_ms"),
            "bound_by": rec.get("bound_by"),
            "library_ms": rec.get("library_ms"),
            "ms_f32": f32.get("ms"), "plain_ms_f32": f32.get("plain_ms"),
            "bound_ms_f32": f32.get("bound_ms"),
            "library_ms_f32": f32.get("library_ms"),
            # `ms` is device time (a CUDA graph of back-to-back calls,
            # replayed); these are the same calls made from the host
            "eager_ms": rec.get("eager_ms"),
            "library_eager_ms": rec.get("library_eager_ms"),
            **extra,
        })
    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
