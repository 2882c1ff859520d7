"""Smoke run of the PyTorch/CUDA port (granite_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Probe: card name and power limit, torch/CUDA versions, nvcc; builds
   the Hopper kernels from granite_tpu_torch/csrc, one nvcc per source
   in parallel (build seconds), and reads each CUDA kernel's registers,
   local (spill) bytes and static shared memory (cudaFuncGetAttributes).
   Then the compile probe's path (granite_tpu_torch.tools.
   compile_parallel_probe), counted from 0: two nvcc builds of kernel B5
   one after the other and two from two threads at once (their wall
   seconds and OVERLAPS or serialized), then its four bodies through B5.
2. One phase per kernel at the bench frame's shapes (Sponza-class bench
   scene, 1920x1080, the bench config): the kernel and its plain PyTorch
   version on the same inputs on the card, compared, both timed, and the
   least time the card could take for the same work (bound).
     B1 sun shadow map 2048^2, and one 512^2 slice of the clustered light
        shadow atlas: depth and triangle ids exact.
     B2 G-buffer raster + resolve: coverage and depth exact, planes at
        tests/test_raster_fused.py's tolerances.
     B3 material (f16, C=12) and environment (f32, C=4) fetch, with the
        main path's inputs (strided uv views, no copies): 1e-6; again at
        1440x810 and on edge-case batches at 1920x1080 and 37x53 (bundle
        -1 and >= N, u, v past the int32 range or non-finite, lod NaN,
        +-inf or huge, fully magnified and fully minified regions).
     B3T VSM moment fetch, 2048^2 moments of the sun map at the bench
        view's half-res coordinates (960x540): 1e-6; its yardstick is
        F.grid_sample on the same coordinates (library_ms).
     B4 deferred lighting: 3e-4 of the output's magnitude; once without
        and once with the AO plane (has_ao, from ops/ssao at 1080p).
   B2 and B4 again at 1440x810, the FSR2 render size (a partial 128-px
   tile column; B2 with the previous-position planes, as under TAA), at
   the same gates.  B1 and B2 are compared on the whole padded target.
     B5 the compile probe's body at its four shapes (n_iters 96-99 over
        (256-640, 256) f32), at (37, 53) (numel not a multiple of 4) and
        on a contiguous view 4 bytes past its allocation: bit-equal
        (torch.equal); and a chain of eight calls, each reading the output
        of the one before (a programmatic launch that did not wait for
        it would read stale memory), captured in a CUDA graph and
        replayed on fresh inputs: bit-equal.  Each case also timed as the
        probe calls it (ms_synced: one call between CUDA events, then a
        sync) and held to its latency/issue floor (latency_bound_ms:
        compile_parallel_probe.latency_bound on the FMUL/FADD count of
        the instance's SASS, from cuobjdump, at the SM's max clock from
        nvidia-smi; no launch term).
     B1 on the occlusion path's phase 1 at 1920x1080 (CULL_BACK, the
        main camera, last frame's visible set) and on the volumetric
        path's 8x8 bake face with the most valid triangles (one tile, a
        chunk of up to 65,536 triangles), each on the first triangle
        chunk the path bins: exact.
     B4 on that 8x8 face of the volumetric diffuse bake (no lights, no
        shadow map): 3e-4 relative.
   Then the launch floor: x.add_(1.0) on one float32 timed as the kernels
   are (a CUDA graph of 20 calls), the least a captured call takes; the
   kernels JSON carries it as launch_floor_ms.
   Timing: a kernel's ms is device time, CUDA events around the replay
   of a CUDA graph that captured N calls of its wrapper (the wrapper's
   own small torch ops included), after a warm-up call; plain_ms and
   library_ms use the same method where the call can be captured, the
   plain versions (which read sizes back to the host) CUDA events around
   N calls.  bound_ms is the larger of the bytes the function must move
   (inputs once, outputs once) at 3.35 TB/s and its FP32 operations at
   67 TFLOP/s (the H100 SXM data sheet's peaks); for B1/B2 the inputs
   are the lanes the walk needs of each binned packet row and the lanes
   the resolve reads of each winning triangle (walk_bound); for B3 the
   bundle of every pixel, u, v and lod of the pixels with a bundle and
   each distinct strip row the live pixels read; for B3T the mask of
   every pixel, u and v of the live pixels and each distinct moment
   texel of their 2x2 footprints.
3. Main paths, each with the launch counts set to 0 just before it and
   read just after: SceneViewerApplication(device="cuda") on the bench
   scene at 1920x1080, 2 warm-up frames then 8 frames through
   render_frames_chained, ms/frame from CUDA events and the host clock;
   image gate, launch counts (every kernel of the path > 0) and the
   raster overflow counters; each chained path's checksum (the float32
   sum the chain keeps on the device of its frames' backbuffers but the
   last) within CHECKSUM_REL_GATE of the float64 sum of those frames;
   then 2 more frames under torch.profiler give the device's busy time a
   frame, and 1 - busy / ms its idle share.
     deferred:      the bench config (deferred HDR), camera orbiting
                    (camera_orbit=0.01).
     forward:       the bench config with the forward renderer, VSM sun
                    shadows and FXAA (B1, B2, B3, B3T, B4), orbiting.
     deferred_post: the bench config with TAA, volumetric fog, SSAO
                    (B4 with AO) and SSR.
     fsr2:          the bench config with FSR2 at resolutionScale 0.75
                    (renders 1440x810, outputs 1920x1080).
     ocean_ground:  the bench config with the FFT ocean and the terrain
                    (BASELINE config 5; rasterMaxVisible raised by the two
                    grids' 65,536 triangles), orbiting.  Its raster
                    overflow and clamp counters must read 0, and two
                    chained frames from the same history at elapsed times
                    0 and 5 s must differ where two at 0 s agree.
     decals_meshlet: the bench config with every mesh re-encoded through
                    the MLT2 meshlet codec and 16 volumetric decals
                    placed with the scene API on the surfaces at a grid of
                    frame 0's pixels, orbiting.  Before its counts are
                    reset, frame 0 without the decals must differ from
                    frame 0 with them in >= 0.1% of the pixels.
     gltf_animated: a `.scene` file loaded through the viewer's scene
                    argument, rendered through its camera 0: the bench
                    scene written as glTF by the port's exporter (with a
                    camera node), 4 instances of the skinned character
                    and the morph sheet of tests/gltf_fixtures.py
                    (rasterMaxVisible raised by their 106,496 triangles),
                    orbiting; every frame animates, and B1 rasterizes the
                    skinned casters into the sun map.  Set-up includes
                    writing and parsing the files.  B1 must launch at
                    least once in every timed frame, the raster overflow
                    and clamp counters read 0, and two frames from the
                    same history at elapsed 0 and 1 s must differ where
                    two at 0 s agree.  After its counts are read, B1 is
                    held against its plain version on the frame's
                    dynamic casters (2048^2).
     occlusion:     the bench config with occlusionCulling: B1 in each
                    of the two phases of HiZ culling on the main camera
                    (a launch per 65,536 valid triangles), the classic
                    resolve, B3, B4, orbiting from a walk-through camera
                    at eye height in the scene's corner.  B1 must launch
                    at least twice in every timed frame, both phases'
                    overflow and clamp counters read 0, some timed frame
                    must cull an object, and the two timed frames that
                    culled most, rendered again with every object in
                    last frame's visible set, must agree within 1 LSB.
     volumetric:    the bench config with volumetric fog, its default
                    fog region and the volumetric diffuse bake over the
                    scene bounds (set-up includes the bake), orbiting.
                    Frame 0 must differ from frame 0 without the volumes
                    in >= 0.1% of the pixels.
     cascades:      the bench config with cascaded sun shadows (four
                    2048^2 maps fitted around the camera, B1 on each
                    every frame), PCFKernelWide, the clustered lights'
                    VSM atlas and showUi, orbiting from the occlusion
                    path's walk-through camera.  B1 exactly 4 times in
                    every timed frame, every raster counter 0, B1 against
                    its plain version on cascades 0 and 3 of the last
                    timed frame (exact), >= 50% of its covered pixels
                    inside a cascade; frame 0 must differ from frame 0
                    with the single fitted sun map in >= 0.1% of the
                    pixels (any change: both shadow the same casters,
                    the cascades move penumbrae) and, inside the UI
                    window's rectangle only, from frame 0 without the
                    UI.  The host ms of the UI tree and of the overlay's
                    upload are printed.
     msaa:          the bench config with msaa 4 (B2, B3 and B4 at
                    3840x2160, the tonemap's 2:1 box to 1920x1080) and
                    renderTargetFp16, orbiting: B2, B3 and B4 in every
                    timed frame, float16 HDR targets; then B2 (exact), B3
                    (1e-6) and B4 (3e-4 relative) against their plain
                    versions at 3840x2160, and B3 and B4 refusing float16
                    inputs.
     streaming:     the bench config with textureStreaming on the bench
                    scene written as glTF by the port's exporter, each of
                    its 5 materials with 4 STREAM_IMAGE^2 images from a
                    numpy seed and their .gtpx sidecars from the port's
                    encoders (tests/streaming_fixtures.py: base colour
                    BC7/BC3/RGBA8, metallic-roughness BC1, normal BC5,
                    emissive BC6H), streamed at texture_size 512, the
                    camera framing the bounds.  Set-up prints the scene
                    write and the encodes apart, then the host ms of one
                    image of each format.  Phase a (no budget): frame 0's
                    bundle rows must equal the fallback strip; then
                    render_frame + post_frame (the device idle before
                    each latch, so its upload time is the copy alone)
                    until every asset is resident, within STREAM_CAP_S;
                    each latch's rows, strip build and upload ms; these
                    frames are its warm-up.  Then 8 timed and 2 traced
                    frames of render_frame + post_frame, orbiting (not
                    chained: the chain never latches), through the same
                    timing and gates as every path, B2 once, B3 twice
                    and B4 once in each timed frame; every row on the
                    card byte-equal to the strip the CPU code builds from
                    the same files; the resident frame differs from
                    frame 0 (both from a fresh history) in >= 0.1% of the
                    pixels; B2 (exact) and both B3 fetches (1e-6) against
                    their plain versions on the last timed frame's inputs,
                    the material fetch reading the 5 streamed rows.  Phase b
                    (textureBudgetMB STREAM_BUDGET_MB, a new viewer): 10
                    frames, current_cost <= the budget after every
                    iterate(), at least one eviction, every frame through
                    the image gate; rows latched and evictions a frame.
                    Then the sidecars are deleted: the scene streamed to
                    residency must render bit-equal to it with
                    textureStreaming false (same bundle bytes, same
                    kernels).
     baked_env:     the bench config with a baked environment: set-up
                    bakes the viewer's own sky (procedural_sky_equirect
                    (128) with its sky_params) through `python -m
                    granite_tpu_torch.tools.convert_equirect_to_environment`'s
                    entry point at --size BAKE_SIZE (the viewer's strip
                    size) --samples BAKE_SAMPLES on the card, and again
                    on the CPU (the card's GGX chain within BAKE_REL_GATE
                    of each level's magnitude; both bakes' seconds), then
                    sets app.environment to Environment(sky, sky_params,
                    baked=the card's bake): B3's environment fetch reads
                    the prefiltered chain, extended by box mips, through
                    the bench strip's shape.  Orbiting.  The frame from a
                    fresh history differs from the default environment's
                    frame from the same camera and history in >= 0.1% of
                    the pixels; B3's f32 C=4 environment fetch on the
                    last timed frame's inputs against its plain version
                    (1e-6) on the baked strip and, for the same inputs,
                    on the default strip, both timed.
     auto_halfspec: the bench config with rasterMaxVisible "auto" and
                    envSpecularHalfRes, orbiting: B3's environment fetch
                    at 960x540 in every frame, upsampled; the compaction
                    capacity auto chose in each timed frame printed (0:
                    the orbit sees every triangle).  Then B3's
                    environment fetch on the last timed frame's half-res
                    inputs against its plain version (1e-6), timed; and,
                    as the orbit leaves auto at 0, a new viewer's frame
                    from the wall view (inside the atrium, toward its +x
                    wall): its capacity strictly between 0 and the
                    scene's total, B2 launched and no triangle dropped,
                    the frame bit-equal to the same frame uncapped, and
                    B2 at that capacity against its plain version.
     forward_pcf:   BASELINE config 2, the glTF viewer's forward path:
                    forward_shadow's knobs (forward, no bloom, no
                    clustered light shadows, no post AA) with a 2048^2
                    sun map under the 2x2 PCF (no VSM) and the bench cap,
                    on the bench scene written as .gltf by the port's
                    exporter at run time and loaded through the viewer's
                    scene argument (set-up includes the write and the
                    parse; the triangles, meshes, objects and lights the
                    viewer took from the file printed), the camera
                    framing its bounds, orbiting.  B1 at set-up (the
                    static sun map) and in no timed frame, B2, B3 and B4
                    in every timed frame, B3T never, every raster counter
                    0.
     aa_fxaa, aa_taa, aa_smaa, aa_smaaT2X, aa_fxaa2phase, aa_taa_extreme:
                    BASELINE config 4, the post-AA suite on the deferred
                    graph: the bench config with postAA fxaa, taa, smaa,
                    smaaT2X, fxaa2phase or taa-extreme and nothing else.
                    Launches at set-up and in each timed frame those of
                    the deferred path; the graph holds the mode's passes
                    (the TAA family's taa-resolve before the tonemap, the
                    LDR pass smaa or fxaa after it) and their device ms
                    are printed.  The TAA family chains a still, jittered
                    camera: the jitter phase advances by one a timed
                    frame and each frame's view-proj moves, and the
                    history is live (the last timed frame rendered again
                    from its own history is the same within 8 levels
                    where, from the graph's initial taa-history, it
                    differs).  The last backbuffer differs in >= 0.1% of
                    the pixels from deferred's frame from the same camera:
                    deferred's last (the same orbit) for fxaa and smaa,
                    its first timed frame (unyawed) for the TAA family.
     video_player:  `python -m granite_tpu_torch.app.video_player`'s
                    entry point (main) on the card at 1920x1080 with
                    --video-size 1024 over a PNG sequence of VIDEO_COUNT
                    seeded 1920x1080 frames written at run time (blocks of
                    noise, frame i bright in channel i % 3), 2 warm-up
                    and 16 timed frames at --time-step 0.0333 with --stat,
                    GRANITE_VULKAN_SWAPCHAIN_IMAGES 2: exit 0, the image
                    gate, the quad over > 15% of the frame, each frame's
                    quad dominated by its video frame's channel, 18
                    frames decoded, every slot the ring hands back with
                    its event complete (query()), no launch of B1-B5.
                    ms/frame from CUDA events around each frame and from
                    the stat JSON (host clock), decode host ms a frame
                    (VideoSource.read_frame), then 2 traced frames.
   deferred_post, fsr2 and the TAA family's aa_ paths are TAA paths:
   their chained camera stands still and only the jitter moves, as in the
   reference's chained TAA.
   The traced frames also give each pass's device time a frame (the
   render graph's `pass:` ranges and the viewer's `decals` range).
   Phase tools, its launches counted from 0 like the compile probe's,
   each tool through its entry point (main) with --device cuda:
   brdf_lut_generate at its defaults (256^2, 512 samples; seconds) and
   integrate_brdf at BRDF_CHECK_SIZE on the card against the CPU
   (BRDF_GATE); hw_verify at 1920x1080 (exit 0, its report printed as one
   JSON line; sequential and chained frames byte-equal; B2 once a chained
   frame; its chain checksum finite and within 0.5-1.5x of 3 times the
   last frame's sum); quality_receipt at 1920x1080 (luma PSNR, max abs diff,
   changed share); aa_bench at its defaults (640x360, 16 chained frames,
   a viewer process a mode) but 4 of its 6 modes, AA_MODES (the aa_
   paths render smaa and smaaT2X at 1920x1080); every mode's
   PNG through the image gate; us and PSNR a mode); sweep_scene with the bench config,
   SWEEP_ITERATIONS iterations at its defaults (1280x720, 32 frames, a
   viewer process an iteration); gltf_repacker --meshlets
   --compress-textures on the streaming path's glTF bench scene (its
   images without sidecars): vertices before and after, MLT1 meshlets,
   seconds; every repacked mesh through MLT1 and back within a 16-bit
   step of its extent; the repacked file's frame and the source's at
   1920x1080 through the image gate, their luma PSNR printed.
   Phase host_subsystems, its launches counted from 0 (all must stay 0:
   these modules hold no tensor), on the card machine's host: physics
   (the two-box stack and a sphere dropped on the plane, PHYSICS_S of
   1/300 s ticks: the stack stands, the sphere rests, the sphere-floor,
   box-floor and box-box CollisionEvents fire; ms a tick); audio (every
   one of the mixer's 128 slots: 127 seeded SineStreams and one
   WavStream, AUDIO_S at 48 kHz in 256-frame blocks through
   WavFileBackend: the file's length, its loudness, the WAV's
   stream_stopped message, a full mixer's -1; ms a block against the
   block's 5.33 ms of audio); netfs (a NetfsServer over a MemoryBackend
   with one NETFS_BLOB_BYTES blob, the size of the streaming path's strip
   row, and small files, read back byte-equal through NetfsBackend
   mounted in the port's Filesystem; MB/s); pyro (the TCP and UDP
   handshake between the port's PyroServer and PyroClient, then
   PYRO_FRAMES frames of the deferred path's 1920x1080 RGBA8 backbuffer,
   each rolled by its index, through send_frame with PYRO_FEC stripes and
   one data subpacket dropped a frame (the first, the tail, then seeded),
   each reassembled byte-equal with the drop recovered; ms a frame).
   Phase parallel (granite_tpu_torch.parallel; launches counted in each
   rank from its start, summed over the ranks): PARALLEL_RANKS gloo
   ranks on the one card (launch.spawn_ranks).  (a) The bench scene's
   1920x1080 main view (every triangle, CULL_BACK) through
   rasterize_binned_sharded: the gathered depth and ids exactly the
   unsharded B1's, each band's count the plain band_cull_setup's, the
   counts' sum < 2x the valid total, no band overflow, B1 once a rank
   (the largest band's share printed: the view is not spread evenly over
   its rows, so the JAX test's max <= max(3 x total / n, 64) is held on
   (b) only); then each band's
   B1 inputs against the plain version (exact), timed alone on the card
   (the ranks take turns), with walk_bound, beside B1 on the whole view
   unsharded (timed in the parent, not counted).  (b) The same on the JAX
   dryrun's 24-sphere field at SPHERES_W x SPHERES_H, with the JAX
   test's balance gate.  (c) The deferred
   bench frame (BENCH_CONFIG) through shard_frame_step, WARMUP +
   PARALLEL_FRAMES frames: rank 0's gathered backbuffer against the same
   frames unsharded in rank 0 (u8 max |diff| <= 2, mean < 0.05, JAX's
   sharded-frame gate), the luminance history equal on every rank, 1
   all_reduce and >= 1 all_gather a timed frame, each rank's launches a
   frame those of the unsharded frame (B2 1, B3 2, B4 1); ms/frame on
   rank 0 (CUDA events), the collectives' host ms, the placement.
   (d) (c) on one nccl rank, at the same gate (its max |diff| printed).
4. Cross-device checks at 128x72 on the card and on the CPU (plain
   versions), luma PSNR >= 48 dB: the golden configs deferred_hdr,
   forward_shadow, deferred_smaa, forward_vsm_fxaa, deferred_taa_fog,
   deferred_fsr2, deferred_ssao_ssr, deferred_ocean_ground,
   deferred_decals (also once with one decal node, as
   tests/test_decals.py places it), deferred_meshlet and deferred_hdr on
   a `.scene` of the test scene, one character and the morph sheet
   through its camera 0, deferred_hdr with occlusionCulling and
   deferred_taa_fog with fog regions and volumetric diffuse (resolution
   2, 8x8 faces), forward_shadow with cascades and PCFKernelWide,
   deferred_hdr with clusteredLightsShadowsVSM and with msaa 4 +
   renderTargetFp16, deferred_taa_fog with showUi, deferred_hdr and
   forward_vsm_fxaa with rasterMaxVisible "auto" and envSpecularHalfRes
   from a camera for which auto caps the compaction, deferred_taa_fog
   without the fog volume under postAA smaaT2X, fxaa2phase and
   taa-extreme (as tests/test_torch_aa_suite.py holds them against JAX),
   forward_shadow with postAA none on the test scene written as .gltf by
   the port's exporter and loaded through the scene argument, each with
   materialTileSampler "true": "auto" takes the tiled routes on the card
   only (the VSM term through B3T, the full-resolution specular
   environment), and "true" sends the CPU down the same ones.  Then
   deferred_hdr with textureStreaming on the test scene with four
   STREAM_SMALL_IMAGE^2 images a material and their sidecars, each device
   latching until every asset is resident (ThreadGroup.wait_idle between
   latches), then 2 frames from a fresh history.  Then the
   triangle demo (BASELINE config 1) through `python -m
   granite_tpu_torch.app.triangle_demo`'s entry point at 1280x720, 4
   frames: image gate, and its PNG against the same frame on the CPU.
   Then the video player at VIDEO_SMALL (480x270, --video-size 64) over
   the same frames, card against CPU.
5. Spans (granite_tpu_torch/utils/timeline_trace.py), after the parallel
   phase, on each benchmark cell's configuration at its size and on its
   orbit (forward_pcf at 1920x1080, deferred at 3840x2160; bench.py's
   ORBIT radius and height, looking at the atrium's centre, 0.01 rad a
   frame), after 8 warm-up frames: 2 x SPAN_FRAMES frames of the
   headless loop, a FrameRecorder on every other one (the recorder's on
   cost: its frame:render against the host ms of the render_frame calls
   of the frames between, within 10%, and every
   span named pass:*, frame:* or decals); one frame with the recorder
   under torch.profiler (up to TRACE_ATTEMPTS until the card's records
   keep every copy): its cudaMemcpyAsync calls must equal uploads +
   readbacks + the card's DtoD copies, the Memcpy DtoH ops the
   readbacks, the Memcpy HtoD ops at most the uploads, and no
   device-side event may be named frame:*; one frame with the recorder
   under torch.cuda.set_sync_debug_mode("warn"): the synchronizing calls
   inside render_frame must equal its readbacks plus its blocking
   uploads (those not staged: a copy from pageable host memory
   synchronizes too; a staged one, from the ring's pinned arena, does
   not), and on the frame path every upload is staged; the cell's trace_frames
   under torch.profiler: each idle gap of the card put down to the
   innermost span the host was in at its middle, and each stage range's
   device ms.  Then SPAN_OFF_CALLS empty spans with tracing off: us each,
   at most 1; and the host us an upload of UPLOAD_SIZES float32s costs
   (UPLOAD_CALLS, the card idle, median of UPLOAD_ROUNDS interleaved
   rounds) by each route: the blocking copy, the ring's pinned arena
   (upload()), and a pinned block of PyTorch's caching host allocator a
   copy.  `python3 chip_smoke.py --spans` runs
   the probe and this phase alone.
Each phase's wall seconds are printed when it ends.
Any failure raises and exits non-zero without the final result line.
The last three lines are the kernels JSON (ms, plain_ms, bound_ms of the
1080p bench-shape case, the other cases under "cases", max_abs_err over
every case of the kernel, launches summed over the main paths and per
path, the compiler's attributes; launch_floor_ms; the tools phase's
numbers under "tools", the host subsystems' under "host_subsystems",
the spans phase's under "spans"), the card, then the result.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import time
import types

from granite_tpu_torch.app.bench_scene import BENCH_CONFIG

FORWARD_CONFIG = {"renderer": "forward", "hdrBloom": True,
                  "shadowMapResolution": 2048,
                  "directionalLightShadowsVSM": True, "postAA": "fxaa",
                  "rasterMaxVisible": 163840}
POST_CONFIG = {**BENCH_CONFIG, "postAA": "taa", "volumetricFog": True,
               "ssao": True, "ssr": True}
FSR2_CONFIG = {**BENCH_CONFIG, "postAA": "taaFSR2", "resolutionScale": 0.75}
# The bench cap plus the ocean's and the terrain's 128^2-quad grids.
OCEAN_CONFIG = {**BENCH_CONFIG, "ocean": True, "terrain": True,
                "rasterMaxVisible": 163840 + 2 * 32768}
DECALS_CONFIG = {**BENCH_CONFIG, "volumetricDecals": True,
                 "meshEncoding": "meshlet"}
# The bench cap plus the characters' and the sheet's triangles
# (tests/gltf_fixtures.py: 24,576 a character, 8,192 the sheet).
CHARACTERS = ((-3.0, 1.6, 3.0), (3.0, 1.6, 3.0), (-3.0, 1.6, -3.0),
              (3.0, 1.6, -3.0))
SHEET_AT = (0.0, 0.3, 6.0)
ANIM_CONFIG = {**BENCH_CONFIG,
               "rasterMaxVisible": 163840 + len(CHARACTERS) * 24576 + 8192}
# The bench glTF's camera: in front of the characters, looking at them.
ANIM_EYE, ANIM_TARGET = (0.0, 5.5, 16.0), (0.0, 1.5, 0.0)
# Two-phase HiZ occlusion culling: B1 in both phases on the main camera,
# here a walk-through view at eye height from the scene's corner (the
# bench camera looks down on the whole scene from outside it, where no
# object hides another: it culls 0 of the 144 objects on the card).
OCCLUSION_CONFIG = {**BENCH_CONFIG, "occlusionCulling": True}
OCCLUSION_EYE, OCCLUSION_TARGET = (12.0, 1.2, 12.0), (0.0, 0.5, 0.0)
# Fog regions (the viewer's default region) and the volumetric diffuse
# bake over the scene bounds; VOLUMES_OFF is the same frame without them.
VOLUMES_OFF = {**BENCH_CONFIG, "volumetricFog": True}
VOLUMES_CONFIG = {**VOLUMES_OFF, "volumetricFogRegions": True,
                  "volumetricDiffuse": True}
# Cascaded sun shadows (4 maps fitted around the camera, B1 on each every
# frame), the 6x6 windowed PCF, the clustered lights' VSM atlas and the UI
# overlay, from the occlusion path's walk-through camera: the bench camera
# sits above the scene, where the 8-64 m cascades cover little it sees.
CASCADES_CONFIG = {**BENCH_CONFIG, "directionalLightShadowsCascaded": True,
                   "PCFKernelWide": True, "clusteredLightsShadowsVSM": True,
                   "showUi": True}
CASCADE_COUNT = 4
# At least this share of the covered pixels lies inside some cascade.
MIN_CASCADE_COVERAGE = 0.5
# msaa 4 (ordered-grid supersampling: B2, B3 and B4 at 3840x2160, the
# tonemap's 2:1 box down to 1920x1080) with float16 HDR targets.
MSAA_CONFIG = {**BENCH_CONFIG, "msaa": 4, "renderTargetFp16": True}
# Texture streaming: the bench scene written as glTF with four
# STREAM_IMAGE^2 images a material (20 in all) and their .gtpx sidecars,
# streamed at the viewer's texture_size 512 (4 MiB decoded an image);
# phase b bounds the decoded bytes at STREAM_BUDGET_MB (12 images).
STREAM_CONFIG = {**BENCH_CONFIG, "textureStreaming": True}
STREAM_IMAGE, STREAM_SEED = 1024, 23
STREAM_BUDGET_MB, STREAM_BUDGET_FRAMES = 48, 10
STREAM_CAP_S = 30.0
# the small streamed test scene of the cross-device check (phase 4)
STREAM_SMALL_IMAGE = 64
# baked_env: the bench viewer's own sky (procedural_sky_equirect(128))
# baked by convert_equirect_to_environment on the card at the viewer's
# strip size (so the baked strip has the bench strip's shape), checked
# against the same bake on the CPU within BAKE_REL_GATE of each level's
# magnitude (float32 atan2 and arccos round differently on the two).
BAKE_SIZE, BAKE_SAMPLES, BAKE_REL_GATE = 256, 64, 1e-4
# The tools phase: brdf_lut_generate at its defaults and again at
# BRDF_CHECK_SIZE on both devices (BRDF_GATE, float64 integration cast
# to f32), sweep_scene's iterations, aa_bench's modes.  With aa_bench's
# 6 default modes (a viewer process each, ~15.7 s) the phase took 156.1 s
# on an NVIDIA H100 80GB HBM3 at 700 W, past its 150 s: smaa and smaaT2X
# are cut (the aa_ main paths render both at 1920x1080).
BRDF_CHECK_SIZE, BRDF_GATE = 64, 1e-6
SWEEP_ITERATIONS = 2
AA_MODES = ("none", "fxaa", "taa", "taaFSR2")
# The host_subsystems phase: simulated seconds (1/60 s iterates of 1/300 s
# ticks); the mix's seconds, rate and block, the WAV stream's seconds;
# the netfs blob (the streaming path's 60.5 MiB strip row); pyro's frames,
# (xor_blocks_even, xor_blocks_odd), and the datagrams in flight before
# the client drains its socket (loopback UDP drops what overflows it).
PHYSICS_S, PHYSICS_STEP = 1.0, 1.0 / 60.0
AUDIO_S, AUDIO_RATE, AUDIO_BLOCK, AUDIO_WAV_S = 2.0, 48000, 256, 1.0
NETFS_BLOB_BYTES, NETFS_READS = int(60.5 * 2 ** 20), 3
PYRO_FRAMES, PYRO_FEC, PYRO_BATCH = 8, (4, 4), 64
HOST_SEED = 41
# The parallel phase: ranks on the one card, timed frames a rank, and the
# JAX dryrun's sphere field (__graft_entry__._dryrun_sharded_raster_1080p).
PARALLEL_RANKS, PARALLEL_FRAMES = 4, 4
SPHERES_W, SPHERES_H = 1920, 1088
# rasterMaxVisible "auto" (the compaction capacity from each frame's
# culling census, 1.5x the visible triangles rounded up to 8,192, 0 at or
# past the scene total) and envSpecularHalfRes (B3's environment fetch at
# every other pixel of the tiled route, upsampled).  The bench orbit sees
# all 258,774 triangles, so auto leaves the compaction off there; the wall
# view, from inside the atrium toward its +x wall, sees 78,694 (the host's
# census), for which auto chooses 122,880.
AUTO_CONFIG = {**BENCH_CONFIG, "rasterMaxVisible": "auto",
               "envSpecularHalfRes": True}
WALL_EYE, WALL_TARGET = (0.0, 2.0, 0.0), (20.0, 2.0, 0.0)
# BASELINE config 2, the glTF viewer's forward path: forward_shadow's knobs
# (tests/golden_utils.py: forward, no bloom, no clustered light shadows, no
# post AA) with a 2048^2 sun map under the 2x2 PCF (no VSM) and the bench
# cap, on the bench scene written as .gltf by the port's exporter.
FORWARD_PCF_CONFIG = {"renderer": "forward", "hdrBloom": False,
                      "shadowMapResolution": 2048,
                      "clusteredLightsShadows": False, "postAA": "none",
                      "rasterMaxVisible": 163840}
# BASELINE config 4, the post-AA suite on the deferred graph: aa_bench's
# modes but none and taaFSR2 (the deferred and fsr2 paths), and the
# viewer's two other TAA-family modes; an aa_ path a mode.  The TAA family
# jitters the camera and resolves against its history before the tonemap;
# the LDR modes run their pass (smaa or fxaa) after it.
AA_PATH_MODES = ("fxaa", "taa", "smaa", "smaaT2X", "fxaa2phase",
                 "taa-extreme")
TAA_FAMILY = ("taa", "smaaT2X", "fxaa2phase", "taa-extreme")
LDR_AA_PASS = {"fxaa": "fxaa", "fxaa2phase": "fxaa", "smaa": "smaa",
               "smaaT2X": "smaa"}
# A chain's checksum (the float32 sum of its frames but the last, on the
# device) against the float64 sum of the same frames: JAX's contract.
CHECKSUM_REL_GATE = 1e-3
# Main paths: name -> (config, kernels it must launch).
MAIN_PATHS = {"deferred": (BENCH_CONFIG, ("B1", "B2", "B3", "B4")),
              "forward": (FORWARD_CONFIG, ("B1", "B2", "B3", "B3T", "B4")),
              "deferred_post": (POST_CONFIG, ("B1", "B2", "B3", "B4")),
              "fsr2": (FSR2_CONFIG, ("B1", "B2", "B3", "B4")),
              "ocean_ground": (OCEAN_CONFIG, ("B1", "B2", "B3", "B4")),
              "decals_meshlet": (DECALS_CONFIG, ("B1", "B2", "B3", "B4")),
              "gltf_animated": (ANIM_CONFIG, ("B1", "B2", "B3", "B4")),
              "occlusion": (OCCLUSION_CONFIG, ("B1", "B3", "B4")),
              "volumetric": (VOLUMES_CONFIG, ("B1", "B2", "B3", "B4")),
              "cascades": (CASCADES_CONFIG, ("B1", "B2", "B3", "B4")),
              "msaa": (MSAA_CONFIG, ("B1", "B2", "B3", "B4")),
              "streaming": (STREAM_CONFIG, ("B1", "B2", "B3", "B4")),
              "baked_env": (BENCH_CONFIG, ("B1", "B2", "B3", "B4")),
              "auto_halfspec": (AUTO_CONFIG, ("B1", "B2", "B3", "B4")),
              "forward_pcf": (FORWARD_PCF_CONFIG, ("B1", "B2", "B3", "B4")),
              **{f"aa_{mode.replace('-', '_')}": (
                  {**BENCH_CONFIG, "postAA": mode}, ("B1", "B2", "B3", "B4"))
                 for mode in AA_PATH_MODES}}
# Golden configs checked card against CPU: label -> (config name, with a
# decal node, scene file (None: the procedural test scene; "anim.scene":
# the small animated `.scene` through its camera 0; "test.gltf": the test
# scene written by the port's exporter, the camera framing its bounds),
# knobs added, camera (eye, target) or None).  Each runs with
# materialTileSampler "true", so both devices take the tiled routes.
CROSS_DEVICE = {name: (name, False, None, {}, None) for name in (
    "deferred_hdr", "forward_shadow", "deferred_smaa", "forward_vsm_fxaa",
    "deferred_taa_fog", "deferred_fsr2", "deferred_ssao_ssr",
    "deferred_ocean_ground", "deferred_decals", "deferred_meshlet")}
CROSS_DEVICE["deferred_decals one decal node"] = (
    "deferred_decals", True, None, {}, None)
CROSS_DEVICE["deferred_hdr gltf_animated scene"] = (
    "deferred_hdr", False, "anim.scene", {}, None)
# (behind the test scene's ring, where its near object hides seven)
CROSS_DEVICE["deferred_hdr occlusionCulling"] = (
    "deferred_hdr", False, None, {"occlusionCulling": True},
    ((6.5, 1.1, 0.0), (0.0, 1.2, 0.0)))
CROSS_DEVICE["deferred_taa_fog fog regions + volumetric diffuse"] = (
    "deferred_taa_fog", False, None,
    {"volumetricFogRegions": True, "volumetricDiffuse": True,
     "volumetricDiffuseResolution": 2, "volumetricDiffuseFaceResolution": 8},
    None)
CROSS_DEVICE["forward_shadow cascades + PCFKernelWide"] = (
    "forward_shadow", False, None,
    {"directionalLightShadowsCascaded": True, "PCFKernelWide": True}, None)
CROSS_DEVICE["deferred_hdr clusteredLightsShadowsVSM"] = (
    "deferred_hdr", False, None, {"clusteredLightsShadowsVSM": True}, None)
CROSS_DEVICE["deferred_hdr msaa 4 + renderTargetFp16"] = (
    "deferred_hdr", False, None, {"msaa": 4, "renderTargetFp16": True},
    None)
CROSS_DEVICE["deferred_taa_fog showUi"] = (
    "deferred_taa_fog", False, None, {"showUi": True}, None)
# (toward the sphere at (3.54, 1, -3.54): the culling census keeps 4,646
# of the test scene's 10,866 triangles, and auto caps the compaction at
# 8,192)
CROSS_DEVICE.update({
    f"{golden} rasterMaxVisible auto + envSpecularHalfRes": (
        golden, False, None,
        {"rasterMaxVisible": "auto", "envSpecularHalfRes": True},
        ((8.0, 2.5, 1.5), (3.54, 1.0, -3.54)))
    for golden in ("deferred_hdr", "forward_vsm_fxaa")})
# The TAA family's other members as tests/test_torch_aa_suite.py holds
# them against JAX (deferred_taa_fog without the fog volume), and config
# 2's knobs on a glTF file.
CROSS_DEVICE.update({
    f"deferred_taa_fog postAA {aa}": (
        "deferred_taa_fog", False, None,
        {"postAA": aa, "volumetricFog": False}, None)
    for aa in ("smaaT2X", "fxaa2phase", "taa-extreme")})
CROSS_DEVICE["forward_shadow from test.gltf"] = (
    "forward_shadow", False, "test.gltf", {"postAA": "none"}, None)
# The video player: VIDEO_COUNT seeded frames of VIDEO_BLOCK-px blocks
# (frame i bright in channel i % 3), rendered at 1920x1080 into a
# VIDEO_SIZE^2 texture; the frame ring VIDEO_RING deep; the quad covers
# more than VIDEO_MIN_COVER of the frame; the card-vs-CPU check's size.
VIDEO_COUNT, VIDEO_BLOCK, VIDEO_SEED, VIDEO_SIZE = 24, 40, 31, 1024
VIDEO_WARMUP, VIDEO_FRAMES, VIDEO_STEP, VIDEO_RING = 2, 16, 0.0333, 2
VIDEO_MIN_COVER = 0.15
VIDEO_SMALL = (480, 270, 64)
# The triangle demo (BASELINE config 1) through its entry point.
TRIANGLE_W, TRIANGLE_H, TRIANGLE_FRAMES = 1280, 720, 4
# Decals of the decals_meshlet path: the viewer's table capacity, each
# box scaled to this share of its distance from the camera.
DECAL_COUNT, DECAL_SIZE = 16, 0.08
# At least this share of the frame's pixels changes under the decals, and
# between the ocean's frames at elapsed times 0 and 5 s and the animated
# scene's at 0 and 1 s.
MIN_CHANGED_SHARE = 0.001
# Least-time yardsticks of the bound (H100 SXM, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations of one (packet, pixel) test of B1/B2, as the plain
# version writes it: 3 edges x (2 sub, 2 mul, 2 add) + the z plane's 6.
EDGE_TEST_OPS = 24
# Bytes of a packet row the walk needs: lanes 0-19 (edges, z plane,
# offset) and 120-124 (zmax, bbox), i.e. the four 32-byte sectors of
# lanes 0-23 and 120-127 that it stages.
WALK_ROW_BYTES = 128
# Lanes the resolve reads of a winner: B1 the tri id (lane 20); B2 the
# payload lanes 21-75, and 76-84 too with the previous-position planes.
B1_WINNER_LANES = 1
B2_WINNER_LANES, B2_PREV_WINNER_LANES = 55, 64
# FP32 operations of B3 as the plain version writes them: 12 a channel
# (four lerps of 2 mul + 1 add) and 15 a pixel (the weights, the scaled
# and floored coordinates, the lod's clamp, floor and frac).
B3_OPS, B3_PIXEL_OPS = 12, 15
WIDTH, HEIGHT = 1920, 1080
WARMUP, FRAMES, ORBIT = 2, 8, 0.01
TRACED_FRAMES = 2
# Traces of a path's TRACED_FRAMES frames taken until one keeps them all.
TRACE_ATTEMPTS = 3
FRAME_TIME = 1.0 / 60.0
PSNR_GATE_DB = 48.0
# id -> (source, TPU kernel it replaces, its CUDA kernels' attribute
# entry points (entry, variant, kernel)).
KERNELS = {
    "B1": ("granite_tpu_torch/csrc/raster_binned.cu",
           "granite_tpu/ops/raster_binned.py:669",
           (("granite_attrs_raster_walk", 0, "raster_walk_kernel"),
            ("granite_attrs_raster_binned_resolve", 0,
             "raster_binned_resolve_kernel"))),
    "B2": ("granite_tpu_torch/csrc/raster_fused.cu",
           "granite_tpu/ops/raster_fused.py:110",
           (("granite_attrs_raster_walk", 0, "raster_walk_kernel"),
            ("granite_attrs_raster_fused_resolve", 0,
             "raster_fused_resolve_kernel"))),
    "B3": ("granite_tpu_torch/csrc/tile_sampler.cu",
           "granite_tpu/ops/tile_sampler.py:420",
           (("granite_attrs_sample_lod", 0, "sample_lod_kernel<half,12>"),
            ("granite_attrs_sample_lod", 1, "sample_lod_kernel<float,4>"))),
    "B3T": ("granite_tpu_torch/csrc/tile_sampler.cu",
            "granite_tpu/ops/tile_sampler.py:420",
            (("granite_attrs_sample_bilinear", 0, "sample_bilinear_kernel"),)),
    "B4": ("granite_tpu_torch/csrc/shade_fused.cu",
           "granite_tpu/ops/shade_fused.py:74",
           (("granite_attrs_shade_fused", 0, "shade_fused_kernel"),)),
    "B5": ("granite_tpu_torch/csrc/compile_probe.cu",
           "tools/compile_parallel_probe.py:44",
           tuple(("granite_attrs_compile_probe", v,
                  f"compile_probe_kernel<{96 + v}>") for v in range(4))),
}


# The spans phase: cell -> (MAIN_PATHS config, width, height, traced
# frames), as in benchmark/traffic/orbit_*.json; the orbit's radius, eye
# height and look-at point.
SPAN_CELLS = {"forward_pcf": (1920, 1080, 16), "deferred": (3840, 2160, 12)}
SPAN_ORBIT_RADIUS, SPAN_EYE_HEIGHT = 55.21653874716373, 25.86809656
SPAN_LOOK = (0.0, 2.896628, 0.0)
SPAN_FRAMES = 64
SPAN_OFF_CALLS = 10**6
SPAN_ON_COST_GATE = 0.1
SPAN_OFF_US_GATE = 1.0
UPLOAD_SIZES = (16, 1024)
UPLOAD_CALLS = 2048
UPLOAD_ROUNDS = 5
UPLOAD_BATCH = 32


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(*args) -> None:
    print(*args, flush=True)


def image_gate(img):
    """bench.py's gate: rgb planes finite, each plane mean in (1, 250)."""
    import numpy as np
    rgb = np.asarray(img, np.float32)[..., :3]
    means = [float(m) for m in rgb.mean(axis=(0, 1))]
    return bool(np.isfinite(rgb).all() and all(1.0 < m < 250.0
                                               for m in means)), means


def host_ms(fn, reps: int) -> float:
    """Mean milliseconds per call, CUDA events around `reps` Python calls
    (one warm call first): the host's time is included, so this is for
    calls that cannot be captured (the plain versions read sizes back)."""
    import torch
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


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call: `reps` calls captured in one
    CUDA graph (after a warm call), replayed once to warm it, then timed
    with CUDA events around one more replay."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def synced_ms(fn, reps: int) -> float:
    """The median milliseconds of `reps` single calls (one warm call
    first), each between CUDA events with a sync after it: what a caller
    that waits for each result sees, launch included."""
    import statistics
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def add_case(results: dict, kid: str, case: dict) -> None:
    """One more checked case of kernel kid (its max_abs_err joins the
    kernel's)."""
    results[kid]["cases"].append(case)
    results[kid]["max_abs_err"] = max(results[kid]["max_abs_err"],
                                      case["max_abs_err"])


def bound(n_bytes: int, n_ops: int = 0) -> dict:
    """The least time for the work: bytes at the memory rate or FP32
    operations at the peak rate, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=n_bytes, ops=n_ops)


def walk_bound(args, out_bytes: int, winner_lanes: int) -> dict:
    """B1/B2's bound on these inputs.  Bytes: the bin offsets; each
    binned packet row once at WALK_ROW_BYTES (rows past the bins and the
    huge lists' spare capacity are never read); `winner_lanes` 4-byte
    lanes of each distinct winning triangle (what the resolve reads);
    the outputs.  Ops: EDGE_TEST_OPS for each (packet, pixel of its bbox
    in a visiting tile) pair of the walk (raster_binned.walk_candidates)."""
    import torch
    from granite_tpu_torch.ops import raster_binned as RB
    st, hs, pk, hr, tx, ty, span_w, span_h = args[:8]
    rows = int(st[-1]) + int(hs[-1])
    _depth, gid = RB.plain_winners(*args[:8])
    ids = torch.cat([pk[:, RB.COL_TRI], hr[:, RB.COL_TRI]]) \
        .contiguous().view(torch.int32)
    winners = int(ids[gid[gid >= 0]].unique().numel())
    cand = RB.walk_candidates(*args[:8])
    _items, n_items = RB.walk_items(st, hs, tx, ty, span_w, span_h,
                                    pk.shape[0], hr.shape[0])
    b = bound(nbytes(st, hs) + rows * WALK_ROW_BYTES
              + winners * winner_lanes * 4 + out_bytes,
              cand * EDGE_TEST_OPS)
    b.update(candidates=cand, work_items=int(n_items[0]), binned_rows=rows,
             winners=winners)
    return b


def make_app(cfg: dict, bench_scene: bool, device: str, scene=None,
             camera_index: int = -1):
    from granite_tpu_torch.app.scene_viewer import SceneViewerApplication
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump(cfg, f)
    try:
        return SceneViewerApplication(types.SimpleNamespace(
            config=f.name, bench_scene=bench_scene, scene=scene,
            camera_index=camera_index), device=device)
    finally:
        os.unlink(f.name)


def write_animated_scene(directory: str, base_info, characters,
                         sheet_at, eye, target) -> str:
    """The `.scene` of the gltf_animated path (and its small
    cross-device twin): base_info written as base.gltf by the port's
    exporter with a camera node at eye looking at target, the skinned
    character at each of `characters` and the morph sheet at sheet_at
    (tests/gltf_fixtures.py).  -> the .scene path."""
    from gltf_fixtures import add_camera, write_scene
    from granite_tpu_torch.scene_export import export_gltf
    export_gltf(base_info, os.path.join(directory, "base.gltf"))
    add_camera(os.path.join(directory, "base.gltf"), eye, target)
    path = os.path.join(directory, "anim.scene")
    write_scene(path, "base.gltf", characters, sheet_at)
    return path


def probe():
    import torch
    from granite_tpu_torch.core import device as D
    from granite_tpu_torch.kernels import build as K
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False")
    card = D.card_identity()
    info = D.describe()
    log("card:", card)
    log(f"torch {info['torch']} cuda {info['cuda']} nvcc {info['nvcc']} "
        f"devices {info['device_count']}")
    t0 = time.monotonic()
    path = K.build()
    K.library()
    log(f"kernels built in {time.monotonic() - t0:.2f} s -> {path}")
    attrs = {}
    for kid, (_src, _rep, entries) in KERNELS.items():
        attrs[kid] = {name: K.kernel_attributes(entry, variant)
                      for entry, variant, name in entries}
        log(f"{kid} attributes {attrs[kid]}")
    return card, attrs


def compile_probe_path() -> tuple[dict, dict]:
    """The compile probe's own path (python -m
    granite_tpu_torch.tools.compile_parallel_probe): two nvcc builds of
    B5 one after the other, two from two threads at once, the verdict;
    then its four bodies through the main library's B5, counted from 0.
    -> (its result, its launches)."""
    import torch
    from granite_tpu_torch.kernels import build as K
    from granite_tpu_torch.tools import compile_parallel_probe as CP
    K.reset_launch_counts()
    r = CP.run_probe()
    outs = CP.run_bodies(torch.device("cuda"))
    launches = dict(K.LAUNCHES)
    log(f"compile probe: serial 2-compile wall {r['serial_s']:.3f} s, "
        f"threaded 2-compile wall {r['threaded_s']:.3f} s ({r['verdict']}; "
        f"OVERLAPS below {CP.OVERLAP_SHARE} x serial); bodies out[0, 0] "
        f"{outs}; launches {launches}")
    check(launches["B5"] == len(CP.PROBE_SHAPES),
          f"the probe's bodies launched B5 {launches['B5']} times")
    return dict(r, bodies=outs), launches


def b1_case(args, label: str) -> dict:
    """Kernel B1 against its plain version, depth and ids exact over the
    whole padded target."""
    import torch
    from granite_tpu_torch.ops import raster_binned as RB
    d_k, t_k = RB.raster_tiles(*args)
    d_p, t_p = RB.raster_tiles_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(t_k, t_p), f"B1 {label} triangle ids differ from plain")
    check(torch.equal(d_k, d_p), f"B1 {label} depth differs from plain")
    err = float((d_k - d_p).abs().max())
    ms = device_ms(lambda: RB.raster_tiles(*args), 10)
    pms = host_ms(lambda: RB.raster_tiles_plain(*args), 1)
    b = walk_bound(args, nbytes(d_k, t_k), B1_WINNER_LANES)
    log(f"B1 {label} ({args[4]}x{args[5]} tiles, span {args[6]}x{args[7]}):"
        f" {int((t_k >= 0).sum())} covered, exact; kernel {ms:.3f} ms, "
        f"plain {pms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']};"
        f" {b['bytes']} B, {b['binned_rows']} binned rows, {b['winners']} "
        f"winners, {b['candidates']} pixel tests, {b['work_items']} slices)")
    return dict(case=label, max_abs_err=err, ms=ms, plain_ms=pms, **b)


def b2_case(app, params, width: int, height: int, prev=False,
            max_visible: int = BENCH_CONFIG["rasterMaxVisible"]):
    """Kernel B2 against its plain version at (width, height), binned with
    visibility compaction to max_visible triangles; prev adds the
    previous-position planes from params' prev_world (TAA).
    -> (planes on the viewport, covered mask, result dict)."""
    import torch
    from granite_tpu_torch.ops import raster as R
    from granite_tpu_torch.ops import raster_binned as RB
    from granite_tpu_torch.ops import raster_fused as RF
    from granite_tpu_torch.renderer import scene_renderer as SR

    packed = app.packed
    ext = params["external"]
    clip, wpos, wnrm, wtan = SR.transform_vertices(
        packed, ext["world"], ext["normal_mats"], params["view_proj"])
    prev_wpos = SR.world_positions(packed, ext["prev_world"]) if prev \
        else None
    setup = R.setup_triangles(clip, packed.indices, width, height)
    setup = setup._replace(
        valid=setup.valid & params["object_mask"][packed.tri_object.long()])
    extra = RF.build_resolve_extra(packed, wpos, wnrm, wtan, prev_wpos)
    payload = torch.cat([RF.fold_adjugate(setup).reshape(-1, 9), extra], 1)
    span_w, span_h = SR.bin_window(width, height)
    pk, st, hr, hs, stats = RB.bin_triangles(
        setup, width, height, span_w=span_w, span_h=span_h, extra=payload,
        max_visible=max_visible)
    tx, ty = -(-width // RB.TILE_W), -(-height // RB.TILE_H)
    args = (st, hs, pk, hr, tx, ty, span_w, span_h, prev)
    # Compared on the whole padded target: kernel and plain version both
    # leave the tile padding past the viewport (outside every bbox) clear.
    p_k = RF.resolve_tiles(*args)
    p_p = RF.resolve_tiles_plain(*args)
    torch.cuda.synchronize()
    cov = p_p[RF.PLANE_COVERED] > 0.5
    check(torch.equal(p_k[RF.PLANE_COVERED], p_p[RF.PLANE_COVERED]),
          f"B2 {width}x{height} coverage differs from plain")
    check(torch.equal(p_k[RF.PLANE_DEPTH], p_p[RF.PLANE_DEPTH]),
          f"B2 {width}x{height} depth differs from plain")
    derivs = list(range(RF.PLANE_DUVDX, RF.PLANE_DUVDY + 2))
    rest = [p for p in range(RF.NUM_PLANES) if p not in derivs]
    check(torch.allclose(p_k[rest], p_p[rest], rtol=2e-4, atol=2e-4),
          f"B2 {width}x{height} attribute planes outside tolerance")
    check(torch.allclose(p_k[derivs], p_p[derivs], rtol=5e-3, atol=5e-5),
          f"B2 {width}x{height} derivative planes outside tolerance")
    err = float((p_k - p_p).abs().max())
    ms = device_ms(lambda: RF.resolve_tiles(*args), 10)
    pms = host_ms(lambda: RF.resolve_tiles_plain(*args), 1)
    b = walk_bound(args, nbytes(p_k),
                   B2_PREV_WINNER_LANES if prev else B2_WINNER_LANES)
    log(f"B2 G-buffer {width}x{height} ({tx}x{ty} tiles, prev planes "
        f"{prev}): {int(cov.sum())} covered, max abs err {err:.3g}; kernel "
        f"{ms:.3f} ms, plain {pms:.3f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}; {b['bytes']} B, {b['binned_rows']} binned rows, "
        f"{b['winners']} winners, {b['candidates']} pixel tests, "
        f"{b['work_items']} slices); bins "
        f"{ {k: int(v) for k, v in stats.items()} }")
    return (p_k[:, :height, :width], cov[:height, :width],
            dict(case=f"{width}x{height}" + (" prev" if prev else ""),
                 max_abs_err=err, ms=ms, plain_ms=pms, **b))


def surface(app, planes, cov):
    """The G-buffer surf dict of B2's planes (material fetch through B3)."""
    import torch
    from granite_tpu_torch.ops import raster_fused as RF
    from granite_tpu_torch.renderer import scene_renderer as SR

    def ch(base, n):
        return planes[base:base + n].movedim(0, -1)

    return SR.material_shade_tail(
        app.packed, pos=ch(RF.PLANE_POS, 3), nrm=ch(RF.PLANE_NRM, 3),
        tan=ch(RF.PLANE_TAN, 4), uv=ch(RF.PLANE_UV, 2),
        duvdx=ch(RF.PLANE_DUVDX, 2), duvdy=ch(RF.PLANE_DUVDY, 2),
        base_factor=ch(RF.PLANE_BASE, 4), mr_factor=ch(RF.PLANE_MR, 2),
        bundle_id=planes[RF.PLANE_BUNDLE].to(torch.int32),
        emissive_factor=ch(RF.PLANE_EMISSIVE, 3), covered=cov,
        lod_bias=0.0)


def b4_case(app, params, surf, label: str, ao=None) -> dict:
    """Kernel B4 against its plain version on a surf dict (with the AO
    plane when given), at the 3e-4 relative gate."""
    from granite_tpu_torch.renderer import scene_renderer as SR
    kw = app.light_kwargs(params, params["static_shadow_depth"])
    args, kkw = SR.shade_inputs(surf, params, ao=ao, **kw)
    check(kkw["has_ao"] == (ao is not None), "B4 has_ao flag")
    return b4_compare(args, kkw, label)


def b4_compare(args, kkw, label: str) -> dict:
    """B4 on shade_inputs' (args, keyword args) against its plain version
    at the 3e-4 relative gate; timed."""
    import torch
    from granite_tpu_torch.ops.shade_fused import (
        shade_planes_fused, shade_planes_plain,
    )
    o_k = shade_planes_fused(*args, **kkw)
    o_p = shade_planes_plain(*args, **kkw)
    torch.cuda.synchronize()
    err = float((o_k - o_p).abs().max())
    rel = err / max(1.0, float(o_p.abs().max()))
    check(rel < 3e-4, f"B4 {label} differs from plain by {rel} (relative)")
    ms = device_ms(lambda: shade_planes_fused(*args, **kkw), 20)
    pms = host_ms(lambda: shade_planes_plain(*args, **kkw), 3)
    # bytes: every tensor input once (planes, light table, tile masks,
    # uniforms) and the output; a few hundred FP32 ops a pixel against
    # ~130 B is far under the card's 20 ops a byte, so bytes bound it.
    b = bound(nbytes(*[a for a in args if hasattr(a, "element_size")], o_k))
    log(f"B4 lighting {label} {args[5]}x{args[4]} ({args[0].shape[0]} "
        f"planes, {args[1].shape[0]} lights, has_ao={int(kkw['has_ao'])}): "
        f"max abs err {err:.3g} (rel {rel:.3g}); kernel {ms:.3f} ms, plain "
        f"{pms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bytes']} B)")
    return dict(case=label, max_abs_err=err, ms=ms, plain_ms=pms, **b)


def sm_max_clock_mhz() -> float:
    """The max SM clock in MHz of torch's card 0: the `nvidia-smi
    --query-gpu=uuid,clocks.max.sm` line whose UUID is that card's (under
    CUDA_VISIBLE_DEVICES nvidia-smi's card 0 may be another)."""
    import subprocess
    import torch
    def bare(uuid) -> str:
        return str(uuid).strip().lower().removeprefix("gpu-")
    want = bare(torch.cuda.get_device_properties(0).uuid)
    out = subprocess.run(["nvidia-smi", "--query-gpu=uuid,clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True, timeout=60)
    mhz = [float(clock) for uuid, clock in
           (line.split(",") for line in out.stdout.strip().splitlines())
           if bare(uuid) == want]
    check(len(mhz) == 1, f"nvidia-smi lists {len(mhz)} cards of UUID {want}")
    return mhz[0]


def b5_chains() -> dict:
    """n_iters -> the FMUL + FADD count of B5's instance in the built
    library's SASS: the dependent chain of one element.  Fails on an FFMA
    (a contracted multiply-add would part from the plain version)."""
    from granite_tpu_torch.kernels import build as K
    from granite_tpu_torch.tools import compile_parallel_probe as CP
    sass = K.sass_counts(K.library_path())
    chains = {}
    for n in CP.PROBE_SHAPES:
        fn = [v for k, v in sass.items()
              if f"compile_probe_kernelILi{n}E" in k]
        check(len(fn) == 1, f"B5 n_iters {n}: {len(fn)} SASS functions")
        check(fn[0]["FFMA"] == 0, f"B5 n_iters {n}: FFMA in its SASS")
        chains[n] = fn[0]["FMUL"] + fn[0]["FADD"]
    log(f"B5 SASS FMUL+FADD (the chain of one element): {chains}")
    return chains


def b5_chain_ok(fn, replays: int = 8) -> bool:
    """fn(x, n_iters) chained eight deep (n_iters 96-99, twice), each call
    reading the output of the one before it, captured in one CUDA graph
    and replayed on `replays` fresh seeded inputs copied into x: is every
    replay bit-equal to the plain chain?  Each B5 in the graph is launched
    while the one before it ends (programmatic dependent launch); one that
    read its input before that kernel's writes landed would read the last
    replay's values, or the pool's, and differ."""
    import torch
    from granite_tpu_torch.tools import compile_parallel_probe as CP
    order = list(CP.PROBE_SHAPES) * 2

    def chain(z, body):
        for n in order:
            z = body(z, n)
        return z

    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.rand((640, 256), generator=g, device="cuda") * 4.0 - 2.0
    chain(x, fn)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = chain(x, fn)
    ok = True
    for _ in range(replays):
        x.copy_(torch.rand(x.shape, generator=g, device="cuda") * 4.0 - 2.0)
        graph.replay()
        ok = torch.equal(out, chain(x, CP.probe_body_plain)) and ok
    del graph
    return ok


def b5_cases() -> dict:
    """B5 against its plain version on seeded inputs on the card, bit-equal
    (torch.equal): the JAX probe's four shapes, (37, 53) with n_iters 96
    and a contiguous 65,536-element view 4 bytes past its allocation with
    n_iters 97; and b5_chain_ok.  Each case: ms (device_ms, a CUDA graph
    of 20 calls back to back), ms_synced (synced_ms, 30 single calls, each
    synced: the probe's own pattern), the roofline bound (x read once
    and the output written once, 2 n_iters FP32 ops an element) and
    latency_bound_ms (CP.latency_bound: the SASS chain, this card's SMs
    and max SM clock), with both shares."""
    import torch
    from granite_tpu_torch.tools import compile_parallel_probe as CP
    clock = sm_max_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chains = b5_chains()
    g = torch.Generator(device="cuda").manual_seed(5)
    inputs = [(n, torch.rand(shape, generator=g, device="cuda") * 4.0 - 2.0,
               f"n_iters {n} {shape[0]}x{shape[1]}")
              for n, shape in CP.PROBE_SHAPES.items()]
    inputs.append((96, torch.rand((37, 53), generator=g, device="cuda")
                   * 4.0 - 2.0, "n_iters 96 37x53"))
    base = torch.rand(65_537, generator=g, device="cuda") * 4.0 - 2.0
    check(base[1:].data_ptr() % 16 == 4, "B5's offset view is not 4 B off")
    inputs.append((97, base[1:], "n_iters 97 65536 at +4 B"))
    check(b5_chain_ok(CP.probe_body),
          "B5 chained in a CUDA graph differs from plain")
    log("B5 chained 8 deep in a CUDA graph, 8 fresh inputs: bit-equal")
    cases = []
    for n, x, label in inputs:
        o_k = CP.probe_body(x, n)
        o_p = CP.probe_body_plain(x, n)
        torch.cuda.synchronize()
        check(torch.equal(o_k, o_p), f"B5 {label} differs from plain")
        ms = device_ms(lambda: CP.probe_body(x, n), 20)
        ms_sync = synced_ms(lambda: CP.probe_body(x, n), 30)
        pms = host_ms(lambda: CP.probe_body_plain(x, n), 3)
        b = bound(nbytes(x, o_k), 2 * n * x.numel())
        lat = CP.latency_bound(chains[n], x.numel(), sms, clock)
        log(f"B5 {label}: bit-equal; kernel {ms:.5f} ms, synced "
            f"{ms_sync:.5f} ms, plain {pms:.3f} ms; bound {b['bound_ms']:.5f} "
            f"ms ({b['bound_by']}; {b['bytes']} B, {b['ops']} ops; share "
            f"{b['bound_ms'] / ms:.3f}); latency bound "
            f"{lat['latency_bound_ms']:.5f} ms ({lat['latency_bound_by']}: "
            f"chain {chains[n]} x {CP.FP32_DEPENDENT_CYCLES} cycles "
            f"{lat['chain_ms']:.5f} ms, issue {lat['issue_ms']:.5f} ms at "
            f"{clock:g} MHz on {sms} SMs; share "
            f"{lat['latency_bound_ms'] / ms:.3f})")
        cases.append(dict(case=label, max_abs_err=0.0, ms=ms,
                          ms_synced=ms_sync, plain_ms=pms, **b,
                          share=b["bound_ms"] / ms, **lat,
                          latency_share=lat["latency_bound_ms"] / ms,
                          chain=chains[n], sm_clock_mhz=clock, sms=sms))
    return dict(cases[0], cases=cases[1:])


def launch_floor() -> float:
    """The timing harness's floor: device_ms of a one-element torch op
    (x.add_(1.0) on one float32, CUDA graph of 20 calls), the least a
    captured call of any wrapper can take; below it a kernel's time is its
    launch, not its work.  The graph's replays must reach x."""
    import torch
    x = torch.zeros(1, device="cuda")
    reps = 20
    ms = device_ms(lambda: x.add_(1.0), reps)
    # device_ms: one warm call, one warm replay and one timed replay
    n = float(x.item())
    log(f"launch floor: x.add_(1.0) on one float32 in a CUDA graph of "
        f"{reps} calls {ms:.5f} ms a call ({n:g} adds reached x)")
    check(n == 1 + 2 * reps, f"the launch floor's graph added {n} times")
    return ms


def view_setup(app, clip, object_mask, width: int, height: int):
    """A camera view's triangle setup on the classic route: CULL_BACK,
    valid only for the triangles of object_mask's objects."""
    from granite_tpu_torch.ops import raster as R
    packed = app.packed
    setup = R.setup_triangles(clip, packed.indices, width, height,
                              cull_mode=R.CULL_BACK)
    return setup._replace(
        valid=setup.valid & object_mask[packed.tri_object.long()])


def b1_chunk_args(setup, width: int, height: int):
    """B1's inputs on the first chunk of a view's valid triangles (up to
    MAX_ENTRIES_PER_TILE), binned with the view's bin window, as
    raster_dispatch.rasterize_binned_exact bins them.  -> (args, valid
    triangles of the view, its chunks)."""
    from granite_tpu_torch.ops import raster_binned as RB
    from granite_tpu_torch.renderer import raster_dispatch as RD
    chunks = RD.valid_chunks(setup)
    span_w, span_h = RD.bin_window(width, height)
    pk, st, hr, hs = RB.bin_triangles(chunks[0][1], width, height,
                                      span_w=span_w, span_h=span_h)[:4]
    return ((st, hs, pk, hr, -(-width // RB.TILE_W), -(-height // RB.TILE_H),
             span_w, span_h), int(setup.valid.sum()), len(chunks))


def walkthrough_app(cfg: dict):
    """A viewer on the bench scene with `cfg` and the occlusion path's
    walk-through camera (occlusion and cascades)."""
    import numpy as np
    app = make_app(cfg, True, "cuda")
    app.camera.look_at(np.asarray(OCCLUSION_EYE, np.float32),
                       np.asarray(OCCLUSION_TARGET, np.float32))
    return app


def slice_kernel_phases(results: dict) -> None:
    """B5 at the probe's shapes and its edge cases; B1 on the occlusion
    path's phase 1 at
    1920x1080 (after one culled frame, so its visible set is last
    frame's); B1 and B4 on the 8x8 face of the volumetric path's bake
    (the viewer's default volume over the bench scene, (8, 2, 8) probes)
    with the most valid triangles (opaque objects): B1 on its first
    chunk, B4 with no lights and no shadow map."""
    import torch
    from granite_tpu_torch.ops.raster_binned import MAX_ENTRIES_PER_TILE
    from granite_tpu_torch.renderer import scene_renderer as SR
    from granite_tpu_torch.renderer import volumetric_diffuse as VD
    results["B5"] = b5_cases()
    app = walkthrough_app(OCCLUSION_CONFIG)
    app.swapchain_updated(WIDTH, HEIGHT)
    app.render_frames_chained(FRAME_TIME, 0.0, 1)
    vis = app._history["vis-history"]
    params = app._param_cache[1]
    ext = params["external"]
    clip = SR.transform_vertices(app.packed, ext["world"],
                                 ext["normal_mats"], params["view_proj"])[0]
    args, n_valid, n_chunks = b1_chunk_args(
        view_setup(app, clip, params["object_mask"] & vis, WIDTH, HEIGHT),
        WIDTH, HEIGHT)
    main = b1_case(args, f"main view 1920x1080, occlusion phase 1, chunk 1 "
                   f"of {n_chunks} ({n_valid} valid triangles)")
    app.declare_diffuse_volume()
    scene = app.scene
    t2w = VD.volume_transforms(scene.world[scene.diffuse_volume_node[0]])[1]
    probes = VD.probe_positions(t2w, scene.diffuse_volume_res[0]) \
        .reshape(-1, 3)
    bake = app.bake_inputs()
    fr = bake["face_res"]

    def face_setup(pos, f):
        return view_setup(app, app.probe_face_view(bake, pos, f)[1],
                          bake["mask"], fr, fr)

    counts = torch.stack([face_setup(pos, f).valid.sum() for pos in probes
                          for f in range(6)]).cpu()
    heaviest = int(counts.argmax())
    pos, f = probes[heaviest // 6], heaviest % 6
    args, n_valid, n_chunks = b1_chunk_args(face_setup(pos, f), fr, fr)
    over = int((counts > MAX_ENTRIES_PER_TILE).sum())
    bake_face = b1_case(args, f"diffuse bake face {fr}x{fr} (probe "
                        f"{heaviest // 6} face {f}, the heaviest of "
                        f"{len(counts)}; {over} hold > "
                        f"{MAX_ENTRIES_PER_TILE}), chunk 1 of {n_chunks} "
                        f"({n_valid} valid triangles)")
    surf, face_params = app.probe_face(bake, pos, f)
    args, kkw = SR.shade_inputs(surf, face_params, width=fr, height=fr,
                                env=bake["env"])
    check(not kkw["has_lights"] and kkw["has_env"], "B4 bake face flags")
    face = b4_compare(args, kkw, f"diffuse bake face {fr}x{fr}")
    for k, case in (("B1", main), ("B1", bake_face), ("B4", face)):
        add_case(results, k, case)
    del app
    torch.cuda.empty_cache()


def b1_sun_args(app, world):
    """B1's inputs for the bench frame's 2048^2 sun shadow map."""
    import torch
    from granite_tpu_torch.ops import raster_binned as RB
    from granite_tpu_torch.renderer import scene_renderer as SR
    size = int(BENCH_CONFIG["shadowMapResolution"])
    light_vp, mask, _dynamic = app.sun_shadow_view()
    setup = SR.shadow_setup(app.packed, world, light_vp, size,
                            torch.as_tensor(mask, device=world.device))
    pk, st, hr, hs = RB.bin_triangles(setup, size, size, span_w=2,
                                      span_h=8)[:4]
    return (st, hs, pk, hr, size // RB.TILE_W, size // RB.TILE_H, 2, 8)


def b1_atlas_args(app):
    """B1's inputs for the first 512^2 slice of the clustered light
    shadow atlas (the first light's first face), as the viewer bakes it."""
    from granite_tpu_torch.ops import raster_binned as RB
    from granite_tpu_torch.renderer import scene_renderer as SR
    size = int(app.config.clustered_lights_shadow_resolution)
    _infos, _assigned, views = app.light_shadow_slices()
    vp, mask = views[0]
    world = app._t(app.scene.world[:app.scene.num_nodes])
    setup = SR.shadow_setup(app.packed, world, vp, size, mask)
    pk, st, hr, hs = RB.bin_triangles(setup, size, size, span_w=2,
                                      span_h=8)[:4]
    return (st, hs, pk, hr, size // RB.TILE_W, size // RB.TILE_H, 2, 8)


def b3_rows(strips, bnd, u, v, lod) -> tuple[int, int, int]:
    """(pixels with a bundle in [0, N), live pixels, distinct strip rows
    they read) of B3 on these inputs: each live pixel (a bundle, finite u
    and v, a lod that is not NaN) reads one 5C-channel row."""
    import torch
    from granite_tpu_torch.ops import texture as TT
    N, rows, S, _ = strips.shape
    L = TT.num_mip_levels(S, S)
    read = (bnd >= 0) & (bnd < N)
    live = read & torch.isfinite(u) & torch.isfinite(v) & ~torch.isnan(lod)
    level = TT.saturating_int32(torch.floor(lod.clamp(0.0, L - 1.0)))
    yy, xx, _fx, _fy = TT._gutter_level_coords(S, u, v, level)
    flat = (bnd.long() * rows + yy.long()) * S + xx.long()
    return int(read.sum()), int(live.sum()), int(flat[live].unique().numel())


def b3_case(name: str, args, reps: int = 20) -> dict:
    """Kernel B3 against its plain version on `args` (strips, bundle, u, v,
    lod, channels) at 1e-6; timed (device time, `reps` calls) unless reps
    is 0.  Bound: the bundle of every pixel; u, v and lod only of the
    pixels with a bundle (the others give 0 whatever they hold); each
    distinct strip row the live pixels read once; the output.  B3_OPS
    FP32 ops a live pixel and channel plus B3_PIXEL_OPS a live pixel."""
    import torch
    from granite_tpu_torch.ops.tile_sampler import sample_lod, sample_lod_plain
    strips, bnd, u, v, lod, c = args
    o_k = sample_lod(*args)
    o_p = sample_lod_plain(*args)
    torch.cuda.synchronize()
    err = float((o_k - o_p).abs().max())
    check(err <= 1e-6, f"B3 {name} differs from plain by {err}")
    read, live, rows = b3_rows(strips, bnd, u, v, lod)
    b = bound(nbytes(bnd, o_k)
              + read * (u.element_size() + v.element_size()
                        + lod.element_size())
              + rows * strips.shape[-1] * strips.element_size(),
              live * (B3_OPS * c + B3_PIXEL_OPS))
    r = dict(case=name, max_abs_err=err, rows=rows, live=live, read=read,
             **b)
    if reps:
        r["ms"] = device_ms(lambda: sample_lod(*args), reps)
        r["plain_ms"] = host_ms(lambda: sample_lod_plain(*args), 3)
    times = (f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
             if reps else "")
    log(f"B3 {name} ({tuple(u.shape)}, u strides {tuple(u.stride())}): max "
        f"abs err {err:.3g} (bit-equal {bool(torch.equal(o_k, o_p))}); "
        f"{times}bound {b['bound_ms']:.4f} ms ({b['bound_by']}; {b['bytes']}"
        f" B, {read} pixels with a bundle, {rows} distinct rows of {live} "
        "live pixels)")
    return r


def b3_main_cases(app, params, planes, cov, surf, label: str) -> list:
    """Both B3 fetches with the main path's inputs: material_shade_tail's
    strided uv views, its torch.where bundle and material_lod's lod; the
    environment fetch of compute_env_products."""
    import torch
    from granite_tpu_torch.ops import raster_fused as RF
    from granite_tpu_torch.renderer import scene_renderer as SR

    def ch(base, n):
        return planes[base:base + n].movedim(0, -1)

    packed = app.packed
    lod = SR.material_lod(packed, ch(RF.PLANE_DUVDX, 2),
                          ch(RF.PLANE_DUVDY, 2), 0.0)
    bundle_id = planes[RF.PLANE_BUNDLE].to(torch.int32)
    bnd = torch.where(cov, bundle_id, torch.full_like(bundle_id, -1))
    uv = ch(RF.PLANE_UV, 2)
    return [b3_case(f"material f16 C=12 {label}",
                    (packed.bundles, bnd, uv[..., 0], uv[..., 1], lod,
                     SR.MATERIAL_CHANNELS)),
            b3_case(f"environment f32 C=4 {label}",
                    b3_env_args(app, params, surf, app.environment.strips))]


def b3_env_args(app, params, surf, strips):
    """B3's environment fetch as compute_env_products makes it, from
    `strips` (the app's environment's or another of its shape)."""
    from granite_tpu_torch.renderer import scene_renderer as SR
    from granite_tpu_torch.renderer.environment import env_fetch_coords
    refl, elod = SR.reflection(surf, params["camera_pos"],
                               app.environment.num_levels)
    eb, eu, ev = env_fetch_coords(strips, refl, surf["covered"])
    return (strips, eb, eu, ev, elod, 4)


def b3_edge_args(strips, channels: int, height: int, width: int, seed: int):
    """B3 inputs at (height, width) that reach every edge: bundle -1 and
    >= N; u and v past the int32 range once scaled, +-inf and NaN (10%);
    lod NaN, +-inf, +-1e30 (5%); the top third fully magnified (lod < 0),
    the middle third fully minified (lod past the last level).  u and v
    are the planes of a (2, H, W + 5) tensor cropped to W, strided views
    like the main path's."""
    import torch
    from granite_tpu_torch.ops.texture import num_mip_levels
    dev = strips.device
    g = torch.Generator(device=dev).manual_seed(seed)
    levels = num_mip_levels(strips.shape[2], strips.shape[2])

    def uniform(lo, hi, shape):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    def sprinkle(x, values, share):
        values = torch.tensor(values, dtype=torch.float32, device=dev)
        pick = torch.randint(0, len(values), x.shape, generator=g,
                             device=dev)
        hit = torch.rand(x.shape, generator=g, device=dev) < share
        return torch.where(hit, values[pick], x)

    inf, nan = float("inf"), float("nan")
    uv = sprinkle(uniform(-2.0, 3.0, (2, height, width + 5)),
                  [3e9, -3e9, 5e9, 7e8, 1e8, inf, -inf, nan], 0.1)
    uv = uv[..., :width]
    third = height // 3
    lod = torch.cat([uniform(-12.0, -1.0, (third, width)),
                     uniform(levels, levels + 8.0, (third, width)),
                     uniform(-1.0, levels + 1.0,
                             (height - 2 * third, width))])
    lod = sprinkle(lod, [nan, inf, -inf, 1e30, -1e30], 0.05)
    bnd = torch.randint(-2, strips.shape[0] + 2, (height, width),
                        generator=g, device=dev, dtype=torch.int32)
    return (strips, bnd, uv[0], uv[1], lod, channels)


def b3t_texels(img, u, v, live) -> int:
    """Distinct moment texels of B3T's 2x2 footprints at the live pixels."""
    import torch
    from granite_tpu_torch.ops.hdr import clamped_floor
    H, W = img.shape[:2]
    x0 = clamped_floor(u * W - 0.5, W - 1).long()
    y0 = clamped_floor(v * H - 0.5, H - 1).long()
    x1, y1 = (x0 + 1).clamp_max(W - 1), (y0 + 1).clamp_max(H - 1)
    flat = torch.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1])
    return int(flat[:, live].unique().numel())


def kernel_phases(results: dict) -> None:
    """Each kernel against its plain version at the bench frame's shapes,
    then B1 on an atlas slice, B4 with AO, then B2 and B4 at the FSR2
    render size."""
    import torch
    import torch.nn.functional as F
    from granite_tpu_torch.ops import raster_fused as RF
    from granite_tpu_torch.ops.shadow import light_uvz, vsm_moments
    from granite_tpu_torch.ops.ssao import ssao, upsample_ao
    from granite_tpu_torch.ops.tile_sampler import (
        sample_bilinear, sample_bilinear_plain,
    )
    from granite_tpu_torch.renderer import scene_renderer as SR

    app = make_app(BENCH_CONFIG, True, "cuda")
    app.swapchain_updated(WIDTH, HEIGHT)
    params = app.build_frame_params(FRAME_TIME)
    packed = app.packed

    # --- B1: the static sun shadow map, then one atlas slice -------------
    results["B1"] = b1_case(b1_sun_args(app, params["external"]["world"]),
                            "sun shadow 2048^2")
    atlas = b1_case(b1_atlas_args(app), "atlas slice 512^2")

    # --- B2: G-buffer raster + resolve ------------------------------------
    planes, cov, results["B2"] = b2_case(app, params, WIDTH, HEIGHT)

    # --- B3: material + environment fetch, as the main path calls it ----
    surf = surface(app, planes, cov)
    b3 = b3_main_cases(app, params, planes, cov, surf, f"{WIDTH}x{HEIGHT}")
    edge = [b3_case(f"{name} edge cases {h}x{w}",
                    b3_edge_args(strips, c, h, w, seed), reps=0)
            for seed, (h, w) in enumerate(((HEIGHT, WIDTH), (37, 53)))
            for name, strips, c in (
                ("material f16 C=12", packed.bundles, SR.MATERIAL_CHANNELS),
                ("environment f32 C=4", app.environment.strips, 4))]

    # --- B3T: VSM moment fetch (the forward path's sun term) -------------
    moments = vsm_moments(params["static_shadow_depth"])
    u, v, _z, inside = light_uvz(params["shadow_uv_mat"],
                                 surf["pos"][::2, ::2])
    live = surf["covered"][::2, ::2] & inside
    vsm_args = (moments, u.contiguous(), v.contiguous(), live.contiguous())
    o_k = sample_bilinear(*vsm_args)
    o_p = sample_bilinear_plain(*vsm_args)
    torch.cuda.synchronize()
    err = float((o_k - o_p).abs().max())
    check(err <= 1e-6, f"B3T differs from plain by {err}")
    ms = device_ms(lambda: sample_bilinear(*vsm_args), 20)
    pms = host_ms(lambda: sample_bilinear_plain(*vsm_args), 3)
    # Yardstick (not used by the port): F.grid_sample with border
    # padding and align_corners=False unnormalises g = 2u - 1 to
    # x = u*W - 0.5, B3T's coordinate; layout and grid made outside.
    img = moments.permute(2, 0, 1)[None].contiguous()
    grid = torch.stack([2.0 * u - 1.0, 2.0 * v - 1.0], -1)[None].contiguous()

    def library():
        return F.grid_sample(img, grid, mode="bilinear",
                             padding_mode="border", align_corners=False)

    lib = library()[0].permute(1, 2, 0)
    lib_err = float((lib[live] - o_k[live]).abs().max())
    check(lib_err <= 1e-5, f"F.grid_sample differs from B3T by {lib_err}: "
          "not the same function, so no yardstick")
    lms = device_ms(library, 20)
    # bytes: the mask of every pixel, u and v of the live pixels (the
    # others give 0 whatever they hold), each distinct moment texel of
    # their 2x2 footprints once (8 B), the output.
    texels = b3t_texels(moments, u, v, live)
    n_live = int(live.sum())
    b = bound(nbytes(vsm_args[3], o_k)
              + n_live * (u.element_size() + v.element_size()) + texels * 8)
    log(f"B3T VSM moments {tuple(moments.shape)} at {tuple(u.shape)} "
        f"({n_live} live): max abs err {err:.3g}; kernel "
        f"{ms:.4f} ms, plain {pms:.3f} ms, grid_sample {lms:.4f} ms (max "
        f"abs diff on live pixels {lib_err:.3g}), bound "
        f"{b['bound_ms']:.4f} ms ({b['bytes']} B, {texels} distinct "
        "moment texels)")
    results["B3T"] = dict(case="960x540 of 2048^2x2", max_abs_err=err, ms=ms,
                          plain_ms=pms, library_ms=lms, texels=texels, **b)

    # --- B4: deferred lighting, then with the SSAO plane -----------------
    results["B4"] = b4_case(app, params, surf, "no AO")
    proj = app.camera.get_projection()
    ao = upsample_ao(ssao(planes[RF.PLANE_DEPTH],
                          z_near=max(app.camera.znear, 1e-3),
                          proj_scale=0.25 * HEIGHT * abs(float(proj[1, 1]))),
                     HEIGHT, WIDTH)
    log(f"SSAO plane {tuple(ao.shape)}: min {float(ao.min()):.3f} mean "
        f"{float(ao.mean()):.3f}")
    ao_case = b4_case(app, params, surf, "AO", ao=ao)
    del app, params, planes, cov, surf, ao
    torch.cuda.empty_cache()

    # --- B2, B3 and B4 at the FSR2 render size ---------------------------
    app = make_app(FSR2_CONFIG, True, "cuda")
    app.swapchain_updated(WIDTH, HEIGHT)
    rw, rh = app._rw, app._rh
    params = app.build_frame_params(FRAME_TIME)
    planes, cov, b2_fsr2 = b2_case(app, params, rw, rh, prev=True)
    surf = surface(app, planes, cov)
    b3_fsr2 = b3_main_cases(app, params, planes, cov, surf, f"{rw}x{rh}")
    b4_fsr2 = b4_case(app, params, surf, "FSR2 render size")
    results["B3"] = dict(
        case=f"material + environment {WIDTH}x{HEIGHT}",
        ms=sum(c["ms"] for c in b3), plain_ms=sum(c["plain_ms"] for c in b3),
        **bound(sum(c["bytes"] for c in b3), sum(c["ops"] for c in b3)),
        max_abs_err=max(c["max_abs_err"] for c in b3 + b3_fsr2 + edge),
        cases=b3 + b3_fsr2 + edge)
    for k, extra in (("B1", (atlas,)), ("B2", (b2_fsr2,)),
                     ("B4", (ao_case, b4_fsr2))):
        results[k]["max_abs_err"] = max(
            [results[k]["max_abs_err"]] + [c["max_abs_err"] for c in extra])
        results[k]["cases"] = list(extra)
    del app
    torch.cuda.empty_cache()


def device_busy_ms(app, frames: int, run) -> tuple[float, dict]:
    """Device time a frame keeps the card busy: the kernels, copies and
    sets torch.profiler records over `frames` more frames (run(app,
    frames)),
    without the named ranges (they span kernels).  Also each named range's
    device ms a frame: the render graph's `pass:<name>` ranges and the
    viewer's `decals` blend, each the device time of the kernels launched
    inside the range's host-side event.  (key_averages() would merge in
    the range's device-side annotation, whose time is the span from its
    first kernel to its last, idle gaps included.)  A trace that kept
    fewer than `frames` of the graph's last pass ranges lost a frame's
    events (torch.profiler once halved every range of a path) and
    is taken again, up to TRACE_ATTEMPTS times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    last = f"pass:{app.graph._order[-1]}"
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(app, frames)
            torch.cuda.synchronize()
        kept = sum(1 for ev in prof.events()
                   if ev.device_type == DeviceType.CPU and ev.name == last)
        if kept == frames:
            break
        log(f"trace {attempt}: torch.profiler kept {kept} of the {frames} "
            f"traced frames' {last} ranges")
    check(kept == frames, f"no trace kept all {frames} traced frames")

    def named(key):
        return key.startswith("pass:") or key == "decals"
    ranges: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and named(ev.name):
            ranges[ev.name] = ranges.get(ev.name, 0.0) \
                + ev.device_time_total / 1e3 / frames
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and not named(ev.key)) / 1e3 / frames
    return busy, ranges


def backbuffer_diff(a, b, levels: int = 8) -> int:
    """Pixels whose rgb differ by more than `levels` in some channel."""
    d = (a[..., :3].int() - b[..., :3].int()).abs().amax(-1)
    return int((d > levels).sum())


def place_decals(app) -> int:
    """DECAL_COUNT volumetric decals through the scene API, on the
    surfaces seen at an 8x8 grid of frame 0's pixels (B2 + B3 resolve
    them): each a node at the surface point, its local z along the
    surface normal, scaled DECAL_SIZE x its distance from the camera,
    with create_volumetric_decal.  -> decals placed."""
    import numpy as np
    import torch
    from granite_tpu_torch.renderer import scene_renderer as SR
    params = app.build_frame_params(FRAME_TIME)
    ext = params["external"]
    clip, wpos, wnrm, wtan = SR.transform_vertices(
        app.packed, ext["world"], ext["normal_mats"], params["view_proj"])
    surf, _depth, _stats = SR.fused_raster_surface(
        app.packed, clip, params["object_mask"], wpos, wnrm, wtan, WIDTH,
        HEIGHT, max_visible=app._resolved_max_visible())
    ys = torch.linspace(0.1 * HEIGHT, 0.9 * HEIGHT, 8).long()
    xs = torch.linspace(0.1 * WIDTH, 0.9 * WIDTH, 8).long()
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    yy, xx = yy.flatten(), xx.flatten()
    hit = surf["covered"][yy, xx].cpu().numpy()
    check(int(hit.sum()) >= DECAL_COUNT,
          f"only {int(hit.sum())} of 64 grid pixels see a surface")
    pick = np.flatnonzero(hit)[np.linspace(0, int(hit.sum()) - 1,
                                           DECAL_COUNT).astype(int)]
    pos = surf["pos"][yy, xx].cpu().numpy()[pick]
    nrm = surf["normal"][yy, xx].cpu().numpy()[pick]
    eye = np.asarray(app.camera.position, np.float32)
    for p, n in zip(pos, nrm):
        n = n / max(float(np.linalg.norm(n)), 1e-6)
        # the rotation taking +z to n, (w, x, y, z)
        q = np.array([1.0 + n[2], -n[1], n[0], 0.0], np.float32)
        if q[0] < 1e-6:
            q = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
        q /= np.linalg.norm(q)
        size = DECAL_SIZE * float(np.linalg.norm(p - eye))
        node = app.scene.create_node(translation=p, rotation=q,
                                     scale=(size, size, size))
        app.scene.create_volumetric_decal(node, 0)
    app.scene.update_transform_tree()
    return len(pos)


def decal_check(app) -> dict:
    """Frame 0 of the path without decals, then the decals placed, the
    graph re-baked (the decal pass joins, history starts over) and frame
    0 again: >= MIN_CHANGED_SHARE of the pixels must change.  Resets the
    launch counts just before the re-bake: from there on it is the
    path's own run."""
    import torch
    from granite_tpu_torch.kernels import build as K
    plain = app.render_frames_chained(FRAME_TIME, 0.0, 1)
    placed = place_decals(app)
    K.reset_launch_counts()
    app.swapchain_updated(WIDTH, HEIGHT)
    check(app._has_decals, "the decal pass is not in the frame")
    decal = app.render_frames_chained(FRAME_TIME, 0.0, 1)
    torch.cuda.synchronize()
    live = int(app._param_cache[1]["decals"].count)
    changed = backbuffer_diff(plain, decal)
    need = int(MIN_CHANGED_SHARE * WIDTH * HEIGHT) + 1
    log(f"decals: {placed} placed, {live} in the frustum's table; frame 0 "
        f"changes in {changed} pixels (> 8 levels) of {WIDTH * HEIGHT}, "
        f"gate {need}")
    log(f"meshEncoding=meshlet: {app.meshlet_meshes} of "
        f"{len(app.info.meshes)} meshes re-encoded through MLT2")
    check(live == DECAL_COUNT, f"{live} of {DECAL_COUNT} decals visible")
    check(changed >= need, f"decals changed {changed} < {need} pixels")
    check(app.meshlet_meshes == len(app.info.meshes) > 0,
          "meshes left classic under meshEncoding=meshlet")
    return dict(decals=live, decal_pixels=changed,
                meshlet_meshes=app.meshlet_meshes)


def counters_zero(stats: dict, name: str) -> None:
    """Every raster pass's overflow and clamp counters read 0."""
    for pass_name, st in stats.items():
        for k in ("visible_overflow", "huge_overflow", "clamped_entries"):
            check(st.get(k, 0) == 0, f"{name} {pass_name} {k} = {st.get(k)}")


def time_check(app, stats: dict, name: str, t1: float) -> dict:
    """The gates of a time-varying path: the raster overflow and clamp
    counters read 0 (its meshes fit under its raised rasterMaxVisible),
    and from the same history two chained frames at elapsed times 0 and
    t1 differ while two at 0 agree."""
    import torch
    counters_zero(stats, name)
    hist = app._history
    frames = {}
    for label, t0 in (("a", 0.0), ("b", t1), ("c", 0.0)):
        app._history = hist
        frames[label] = app.render_frames_chained(FRAME_TIME, t0, 1)
    torch.cuda.synchronize()
    moved = backbuffer_diff(frames["a"], frames["b"])
    still = backbuffer_diff(frames["a"], frames["c"])
    log(f"{name}: frames at 0 s and {t1:g} s differ in {moved} pixels, two "
        f"at 0 s in {still}")
    check(moved >= int(MIN_CHANGED_SHARE * WIDTH * HEIGHT) + 1
          and still * 100 <= moved,
          f"{name} does not follow the elapsed time ({moved} vs {still} "
          "pixels)")
    return dict(moved_pixels=moved, still_pixels=still)


def b1_dynamic_case(app) -> dict:
    """B1 on the last frame's dynamic casters (the skinned characters,
    posed by its skin palette), as the shadow pass runs it: their own
    triangles set up and binned into the 2048^2 sun map."""
    from granite_tpu_torch.ops import raster_binned as RB
    from granite_tpu_torch.renderer import scene_renderer as SR
    p = app._param_cache[1]
    size = int(app.config.shadow_map_resolution)
    setup = SR.shadow_setup(app.packed, p["external"]["world"],
                            p["shadow_vp"], size, p["dynamic_shadow_mask"],
                            p["skin_palette"], p["morph_weights"],
                            tris=app._dynamic_tris)
    pk, st, hr, hs = RB.bin_triangles(setup, size, size, span_w=2,
                                      span_h=8)[:4]
    return b1_case((st, hs, pk, hr, size // RB.TILE_W, size // RB.TILE_H,
                    2, 8), "dynamic casters 2048^2")


def occlusion_check(app, stats: dict, b1_frames: list, culls: list,
                    kept: list) -> dict:
    """The occlusion path's gates: B1 at least twice in every timed
    frame, its two phases' overflow and clamp counters at 0, some timed
    frame culling an object, and culling that is conservative: the two
    timed frames that culled most, rendered again from the same params
    and history with every object in last frame's visible set, agree
    with the culled frames within 1 LSB."""
    import torch
    check(len(b1_frames) == FRAMES and min(b1_frames) >= 2,
          f"B1 launches in the {FRAMES} timed frames: {b1_frames}")
    for phase in ("occlusion-phase1", "occlusion-phase2"):
        for k in ("visible_overflow", "huge_overflow", "clamped_entries"):
            check(stats[phase].get(k, 0) == 0,
                  f"occlusion {phase} {k} = {stats[phase].get(k)}")
    table = [{k: int(v) for k, v in c.items()} for c in culls]
    log(f"occlusion: objects {app.packed.num_objects}; each timed frame "
        "(in frustum, phase 1, phase 2, culled) "
        f"{[(c['in_frustum'], c['phase1'], c['phase2'], c['culled']) for c in table]}")
    check(max(c["culled"] for c in table) >= 1,
          "occlusion culled no object in any timed frame")
    picks = sorted(range(len(table)), key=lambda i: -table[i]["culled"])[:2]
    diffs = []
    for i in sorted(picks):
        params, hist, culled = kept[i]
        full, _hist = app.graph.execute(params, {
            **hist, "vis-history": torch.ones_like(hist["vis-history"])})
        torch.cuda.synchronize()
        check(int(app.cull_counts["culled"]) == 0,
              "the all-visible re-render culled objects")
        d = int((culled[..., :3].int() - full[..., :3].int()).abs().max())
        diffs.append(d)
        log(f"occlusion: timed frame {i} ({table[i]['culled']} culled) "
            f"against its all-visible re-render: max difference {d} LSB")
        check(d <= 1, f"culled frame {i} differs by {d} > 1 LSB")
    return dict(culled_per_frame=[c["culled"] for c in table],
                conservative_max_lsb=max(diffs))


def volumes_check(app) -> dict:
    """Frame 0 of the volumetric path from a fresh history must differ
    from the same frame without the volumes (the diffuse probes and the
    fog regions switched off: VOLUMES_OFF) in >= MIN_CHANGED_SHARE of the
    pixels."""
    import torch

    def frame0():
        app.reset_history()
        return app.render_frames_chained(FRAME_TIME, 0.0, 1)

    with_volumes = frame0()
    probes, app._vol_diffuse = app._vol_diffuse, None
    app.config.volumetric_fog_regions = False
    without = frame0()
    app._vol_diffuse = probes
    app.config.volumetric_fog_regions = True
    torch.cuda.synchronize()
    changed = backbuffer_diff(without, with_volumes)
    need = int(MIN_CHANGED_SHARE * WIDTH * HEIGHT) + 1
    vols = app._vol_diffuse["volumes"]
    log(f"volumetric: {len(vols)} diffuse volume(s), probe grid "
        f"{app.scene.diffuse_volume_res}, faces "
        f"{app.config.volumetric_diffuse_face_resolution}^2, baked in "
        f"{app.bake_seconds:.2f} s (B1 counters over its faces "
        f"{ {k: int(v) for k, v in app.bake_stats.items()} }); "
        f"{len(app.scene.fog_region_node)} fog "
        f"region(s); frame 0 changes in {changed} pixels (> 8 levels) of "
        f"{WIDTH * HEIGHT} against frame 0 without them, gate {need}")
    check(changed >= need, f"the volumes changed {changed} < {need} pixels")
    return dict(bake_s=app.bake_seconds, volume_pixels=changed)


def b1_cascade_case(app, params, c: int) -> dict:
    """B1 on cascade c of a frame of the cascades path, as its shadow
    pass runs it: every caster in the sun's frustum (the shadow mask),
    set up through the cascade's view-proj and binned into its 2048^2
    map."""
    from granite_tpu_torch.ops import raster_binned as RB
    from granite_tpu_torch.renderer import scene_renderer as SR
    size = int(app.config.shadow_map_resolution)
    setup = SR.shadow_setup(app.packed, params["external"]["world"],
                            params["cascade_vps"][c], size,
                            params["shadow_mask"], params["skin_palette"],
                            params["morph_weights"])
    pk, st, hr, hs = RB.bin_triangles(setup, size, size, span_w=2,
                                      span_h=8)[:4]
    return b1_case((st, hs, pk, hr, size // RB.TILE_W, size // RB.TILE_H,
                    2, 8), f"cascade {c} {size}^2")


def cascade_coverage(app, params) -> tuple[float, list]:
    """The share of a frame's covered pixels (B2 + B3 at the display
    size) inside the UV footprint of at least one cascade (the blend's
    weight above 0), and the share each cascade is the first to hold."""
    import torch
    from granite_tpu_torch.renderer import scene_renderer as SR
    ext = params["external"]
    clip, wpos, wnrm, wtan = SR.transform_vertices(
        app.packed, ext["world"], ext["normal_mats"], params["view_proj"])
    surf, _depth, _stats = SR.fused_raster_surface(
        app.packed, clip, params["object_mask"], wpos, wnrm, wtan, WIDTH,
        HEIGHT, max_visible=app._resolved_max_visible())
    pos = surf["pos"][surf["covered"]]
    m = params["shadow_uv_mat"]
    uvw = torch.einsum("pk,cjk->cpj", pos, m[:, :3, :3]) + m[:, None, :3, 3]
    margin = torch.maximum((uvw[..., 0] - 0.5).abs(),
                           (uvw[..., 1] - 0.5).abs()) * 2.0
    inside = margin < 1.0
    first = torch.where(inside.any(0), inside.int().argmax(0), -1)
    n = max(int(pos.shape[0]), 1)
    return (float(inside.any(0).sum()) / n,
            [float((first == c).sum()) / n for c in range(m.shape[0])])


def cascades_check(app, stats: dict, frames: list, params,
                   results: dict) -> dict:
    """The cascades path's gates: B1 exactly CASCADE_COUNT times in every
    timed frame; every raster counter 0 (the four cascade maps and the
    G-buffer); B1 against its plain version on cascades 0 and 3 of the
    last timed frame; >= MIN_CASCADE_COVERAGE of that frame's covered
    pixels inside a cascade; frame 0 with the UI against frame 0 without
    it in the window's rectangle; frame 0 with the cascades against frame
    0 with the single fitted sun map in >= MIN_CHANGED_SHARE of the
    pixels.  Also the host ms of the UI tree and of the overlay's upload
    a frame."""
    import torch
    b1 = [f["B1"] for f in frames]
    check(len(b1) == FRAMES and all(n == CASCADE_COUNT for n in b1),
          f"B1 launches in the {FRAMES} timed frames: {b1}")
    for pass_name, st in stats.items():
        for k in ("visible_overflow", "huge_overflow", "clamped_entries"):
            check(st.get(k, 0) == 0, f"cascades {pass_name} {k} = "
                  f"{st.get(k)}")
    for c in (0, CASCADE_COUNT - 1):
        add_case(results, "B1", b1_cascade_case(app, params, c))
    share, firsts = cascade_coverage(app, params)
    log(f"cascades: {share:.4f} of the last timed frame's covered pixels "
        f"inside a cascade (first held by cascade 0-3: "
        f"{[round(f, 4) for f in firsts]}), gate {MIN_CASCADE_COVERAGE}")
    check(share >= MIN_CASCADE_COVERAGE,
          f"cascade coverage {share:.4f} < {MIN_CASCADE_COVERAGE}")
    reps = 8
    t = time.monotonic()
    for _ in range(reps):
        canvas = app.ui_overlay(FRAME_TIME)
    ui_ms = (time.monotonic() - t) * 1e3 / reps
    torch.cuda.synchronize()
    t = time.monotonic()
    for _ in range(reps):
        app._t(canvas)
    torch.cuda.synchronize()
    upload_ms = (time.monotonic() - t) * 1e3 / reps

    def frame0():
        app.reset_history()
        return app.render_frames_chained(FRAME_TIME, 0.0, 1)

    with_all = frame0()
    app.config.show_ui = False
    no_ui = frame0()
    app.config.show_ui = True
    app.config.directional_light_cascaded_shadows = False
    app.swapchain_updated(WIDTH, HEIGHT)
    no_cascades = frame0()
    torch.cuda.synchronize()
    win = app.ui_manager.widgets[0]
    x0, y0 = int(win.x), int(win.y)
    x1, y1 = x0 + int(win.w), y0 + int(win.h)
    ui_pixels = backbuffer_diff(with_all[y0:y1, x0:x1], no_ui[y0:y1, x0:x1])
    outside = backbuffer_diff(with_all, no_ui) - ui_pixels
    # The two maps shadow the same casters: the cascades move penumbrae
    # (cascade 0's texels are ~1/4 of the fitted map's), so the gate
    # counts every pixel that changes, and the > 8 levels count is printed
    changed = backbuffer_diff(with_all, no_cascades, 0)
    strong = backbuffer_diff(with_all, no_cascades)
    need = int(MIN_CHANGED_SHARE * WIDTH * HEIGHT) + 1
    log(f"showUi: window {x1 - x0}x{y1 - y0} at ({x0}, {y0}), label "
        f"'{app._ui_stats_label.text}'; {ui_pixels} of its pixels change "
        f"(> 8 levels), {outside} outside it; host UI tree {ui_ms:.3f} "
        f"ms/frame, overlay upload ({tuple(canvas.shape)} f32, "
        f"{canvas.nbytes} B) {upload_ms:.3f} ms/frame")
    log(f"cascades: frame 0 changes in {changed} pixels ({strong} by > 8 "
        f"levels) of {WIDTH * HEIGHT} against the single fitted sun map, "
        f"gate {need}")
    check(2 * ui_pixels >= (x1 - x0) * (y1 - y0) and outside == 0,
          f"the UI window changed {ui_pixels} pixels, {outside} outside")
    check(changed >= need, f"the cascades changed {changed} < {need} pixels")
    return dict(coverage=share, ui_ms=ui_ms, upload_ms=upload_ms,
                cascade_pixels=changed)


def msaa_check(app, frames: list, results: dict) -> dict:
    """The msaa path's gates: it renders at 2x the display size, B2, B3
    and B4 launch in every timed frame, and its HDR targets are float16
    (the bloom chain's history holds one from the pool); then B2, B3 and
    B4 against their plain versions on a frame at 3840x2160, and B3 and
    B4 refusing float16 inputs (the callers convert)."""
    import torch
    from granite_tpu_torch.ops.shade_fused import shade_planes_fused
    from granite_tpu_torch.ops.tile_sampler import sample_lod
    from granite_tpu_torch.renderer import scene_renderer as SR
    rw, rh = app._rw, app._rh
    check((rw, rh) == (2 * WIDTH, 2 * HEIGHT), f"msaa 4 renders {rw}x{rh}")
    for k in ("B2", "B3", "B4"):
        per = [f[k] for f in frames]
        check(len(per) == FRAMES and min(per) >= 1,
              f"{k} launches in the {FRAMES} timed frames: {per}")
    res = app.graph._resources
    check(res["hdr"].info.dtype == torch.float16, "hdr is not float16")
    check(app._history["bloom-d0"].dtype == torch.float16,
          f"bloom history {app._history['bloom-d0'].dtype}")
    params = app.build_frame_params(FRAME_TIME)
    planes, cov, b2 = b2_case(app, params, rw, rh)
    surf = surface(app, planes, cov)
    b3 = b3_main_cases(app, params, planes, cov, surf, f"{rw}x{rh}")
    b4 = b4_case(app, params, surf, "msaa 4 render size")
    args, kkw = SR.shade_inputs(surf, params, **app.light_kwargs(
        params, params["static_shadow_depth"]))
    refused = []
    for what, fn in (
            ("B4 float16 planes",
             lambda: shade_planes_fused(args[0].half(), *args[1:], **kkw)),
            ("B3 float16 u", lambda: sample_lod(
                app.packed.bundles, torch.zeros_like(cov, dtype=torch.int32),
                surf["pos"][..., 0].contiguous().half(),
                surf["pos"][..., 1].contiguous(),
                surf["pos"][..., 2].contiguous(), SR.MATERIAL_CHANNELS))):
        try:
            fn()
        except ValueError as e:
            refused.append(f"{what}: {e}")
    log(f"msaa: float16 inputs refused: {refused}")
    check(len(refused) == 2, "a kernel took float16 inputs")
    add_case(results, "B2", b2)
    for c in b3:
        add_case(results, "B3", c)
    add_case(results, "B4", b4)
    return dict(render=f"{rw}x{rh}")


def triangle_demo() -> dict:
    """BASELINE config 1 through `python -m granite_tpu_torch.app.
    triangle_demo`'s entry point on the card (TRIANGLE_FRAMES timed
    frames at TRIANGLE_W x TRIANGLE_H), its PNG behind the image gate and
    held against the same frame on the CPU."""
    import numpy as np
    from golden_utils import psnr
    from granite_tpu_torch.app import triangle_demo as TD
    from granite_tpu_torch.utils.image_io import load_image
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "triangle.png")
        t = time.monotonic()
        rc = TD.main(["--width", str(TRIANGLE_W), "--height", str(TRIANGLE_H),
                      "--frames", str(TRIANGLE_FRAMES), "--time-step",
                      str(FRAME_TIME), "--device", "cuda", "--png-path",
                      path])
        wall = time.monotonic() - t
        img = load_image(path)
    check(rc == 0, f"the triangle demo exited {rc}")
    ok, means = image_gate(img)
    cpu = TD.TriangleApplication(device="cpu")
    cpu.swapchain_updated(TRIANGLE_W, TRIANGLE_H)
    # the runner's last timed frame: elapsed TRIANGLE_FRAMES fixed steps
    ref = cpu.render_frame(FRAME_TIME, TRIANGLE_FRAMES
                           * int(FRAME_TIME * 1e9) * 1e-9).numpy()
    p = psnr(img, ref)
    covered = int((np.abs(img[..., :3].astype(int)
                          - img[0, 0, :3].astype(int)).max(-1) > 8).sum())
    log(f"triangle demo {TRIANGLE_W}x{TRIANGLE_H}, {TRIANGLE_FRAMES} frames:"
        f" exit {rc}, {wall:.2f} s wall, image gate ok={ok} rgb means "
        f"{means}, {covered} triangle pixels; cuda vs cpu luma PSNR {p:.2f}"
        " dB")
    check(ok, f"triangle demo image gate failed: means {means}")
    check(covered > 0.05 * TRIANGLE_W * TRIANGLE_H, "no triangle drawn")
    check(p >= PSNR_GATE_DB, f"triangle demo cuda vs cpu PSNR {p:.2f}")
    return dict(psnr=p, wall_s=wall)


def write_video_frames(directory: str) -> None:
    """VIDEO_COUNT 1920x1080 PNGs from VIDEO_SEED: blocks of noise in
    [0, 64), frame i's channel i % 3 in [170, 256)."""
    import numpy as np
    from granite_tpu_torch.utils.image_io import save_png
    rng = np.random.default_rng(VIDEO_SEED)
    rows, cols = HEIGHT // VIDEO_BLOCK, WIDTH // VIDEO_BLOCK
    for i in range(VIDEO_COUNT):
        blocks = rng.integers(0, 64, (rows, cols, 4), dtype=np.uint8)
        blocks[..., i % 3] = rng.integers(170, 256, (rows, cols))
        blocks[..., 3] = 255
        img = blocks.repeat(VIDEO_BLOCK, 0).repeat(VIDEO_BLOCK, 1)
        save_png(os.path.join(directory, f"frame_{i:05d}.png"), img)


def video_frames(app, n: int):
    """n more frames of the video player (the traced frames)."""
    out = None
    for i in range(n):
        out = app.render_frame(VIDEO_STEP, (i + 1) * VIDEO_STEP)
    return out


def video_player_path(seq: str) -> dict:
    """The video player through its entry point on the card (the path in
    the docstring); -> its launches, counted from 0."""
    import torch
    from granite_tpu_torch.app import video_player as VP
    from granite_tpu_torch.kernels import build as K
    from granite_tpu_torch.utils.image_io import load_image
    made, frames, ring, decode = [], [], [], []
    base = VP.VideoPlayerApplication

    class Checked(base):
        """The player, recording itself, each frame's output between two
        CUDA events, each decode's host seconds and, at each move of the
        frame ring, the events of the slot it hands back."""

        def __init__(self, args, device="cuda"):
            super().__init__(args, device=device)
            made.append(self)
            read, hub = self.source.read_frame, self.hub
            move = hub.next_frame_context

            def timed_read():
                t0 = time.perf_counter()
                frame = read()
                decode.append(time.perf_counter() - t0)
                return frame

            def next_frame_context():
                ahead = hub._frames[(hub._frame_index + 1)
                                    % len(hub._frames)]
                events = list(ahead.in_flight)
                slot = move()
                ring.append((len(events), all(e.query() for e in events)))
                return slot

            self.source.read_frame = timed_read
            hub.next_frame_context = next_frame_context

        def render_frame(self, frame_time, elapsed_time):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = super().render_frame(frame_time, elapsed_time)
            end.record()
            frames.append((start, end, out))
            return out

    png = os.path.join(seq, os.pardir, "video.png")
    stat = os.path.join(seq, os.pardir, "video.json")
    env = os.environ.get("GRANITE_VULKAN_SWAPCHAIN_IMAGES")
    os.environ["GRANITE_VULKAN_SWAPCHAIN_IMAGES"] = str(VIDEO_RING)
    # main() builds its app through the module's class name
    VP.VideoPlayerApplication = Checked
    try:
        K.reset_launch_counts()
        t = time.monotonic()
        rc = VP.main(["--video", seq, "--video-size", str(VIDEO_SIZE),
                      "--device", "cuda", "--width", str(WIDTH),
                      "--height", str(HEIGHT), "--frames",
                      str(VIDEO_FRAMES), "--warmup-frames",
                      str(VIDEO_WARMUP), "--time-step", str(VIDEO_STEP),
                      "--png-path", png, "--stat", stat])
        wall = time.monotonic() - t
        launches = dict(K.LAUNCHES)
    finally:
        VP.VideoPlayerApplication = base
        if env is None:
            del os.environ["GRANITE_VULKAN_SWAPCHAIN_IMAGES"]
        else:
            os.environ["GRANITE_VULKAN_SWAPCHAIN_IMAGES"] = env
    check(rc == 0, f"the video player exited {rc}")
    app = made[0]
    torch.cuda.synchronize()
    rendered = VIDEO_WARMUP + VIDEO_FRAMES
    timed = frames[VIDEO_WARMUP:rendered]
    ms = timed[0][0].elapsed_time(timed[-1][1]) / VIDEO_FRAMES
    with open(stat) as f:
        host_ms = json.load(f)["averageFrameTimeUs"] / 1e3
    shares, covers = [], []
    for k, (_s, _e, out) in enumerate(frames[:rendered]):
        rgb = out[..., :3]
        bright = rgb.amax(-1) > 100
        covers.append(float(bright.float().mean()))
        dom = rgb[bright].argmax(-1)
        shares.append(float((dom == k % 3).float().mean()))
    img = load_image(png)
    ok, means = image_gate(img)
    waited = [n for n, _ in ring]
    decoded = app._frames_decoded
    busy_ms, ranges = device_busy_ms(app, TRACED_FRAMES, video_frames)
    log(f"video_player {WIDTH}x{HEIGHT}, texture {VIDEO_SIZE}^2, "
        f"{VIDEO_FRAMES} timed frames: {ms:.3f} ms/frame (CUDA events), "
        f"{host_ms:.3f} ms/frame (host clock, stat JSON); decode "
        f"{1e3 * sum(decode[:rendered]) / rendered:.3f} host ms a frame; "
        f"exit {rc}, {wall:.2f} s wall; device busy {busy_ms:.3f} ms/frame"
        f" over {TRACED_FRAMES} traced frames, idle share "
        f"{1.0 - busy_ms / ms:.3f}")
    log(f"video_player image gate ok={ok} rgb means {means}; quad cover "
        f"{min(covers):.3f}-{max(covers):.3f}; dominant channel shares "
        f"{[round(x, 3) for x in shares]}; frames decoded "
        f"{decoded}; ring events waited a move {waited}, all "
        f"complete {all(c for _, c in ring)}; device ms a frame by range "
        f"{ {k: round(v, 4) for k, v in sorted(ranges.items())} }; "
        f"launches {launches}")
    check(ok, f"video player image gate failed: means {means}")
    check(min(covers) > VIDEO_MIN_COVER, f"the quad covers {covers}")
    check(min(shares) > 0.95, f"dominant channel shares {shares}")
    check(decoded == rendered,
          f"{decoded} frames decoded, {rendered} rendered")
    check(len(ring) == VIDEO_FRAMES and all(c for _, c in ring)
          and waited == [0] * (VIDEO_RING - 1)
          + [1] * (VIDEO_FRAMES - VIDEO_RING + 1),
          f"frame ring: events waited {waited}, complete {ring}")
    check(not any(launches.values()),
          f"the video player launched kernels: {launches}")
    del app, made, frames
    torch.cuda.empty_cache()
    return launches


def video_cross_device(seq: str) -> None:
    """The video player at VIDEO_SMALL on the card and on the CPU over
    the same frames, 3 frames each: luma PSNR >= 48 dB a frame."""
    from golden_utils import psnr
    from granite_tpu_torch.app.video_player import VideoPlayerApplication
    width, height, size = VIDEO_SMALL
    t = time.monotonic()
    imgs = {}
    for device in ("cuda", "cpu"):
        app = VideoPlayerApplication(types.SimpleNamespace(
            video=seq, video_size=size), device=device)
        app.swapchain_updated(width, height)
        imgs[device] = [app.render_frame(VIDEO_STEP, i * VIDEO_STEP)
                        .cpu().numpy() for i in range(3)]
        app.teardown()
    p = [float(psnr(a, b)) for a, b in zip(imgs["cuda"], imgs["cpu"])]
    log(f"cross-device video_player {width}x{height} texture {size}^2: "
        f"cuda vs cpu luma PSNR {[round(x, 2) for x in p]} dB "
        f"({time.monotonic() - t:.1f} s)")
    check(min(p) >= PSNR_GATE_DB,
          f"cross-device video player PSNR {p} < {PSNR_GATE_DB}")


def chained_frames(app, n: int):
    """n chained frames, the camera yawed ORBIT a frame (the bench paths'
    loop).  -> the last backbuffer, on the device."""
    return app.render_frames_chained(FRAME_TIME, FRAME_TIME, n,
                                     camera_orbit=ORBIT)


def stream_frames(app, n: int):
    """n frames of render_frame + post_frame, the headless runner's
    unchained loop (the streaming latch after every frame; the chain never
    latches), the camera yawed ORBIT a frame.  -> the last backbuffer."""
    out = None
    for i in app._orbit(n, ORBIT):
        out = app.render_frame(FRAME_TIME, (i + 1) * FRAME_TIME)
        app.post_frame()
    return out


def main_path(name: str, results: dict, kept: dict) -> dict:
    """One bench frame path through the kernels; returns its launches
    (gltf_animated, cascades, msaa and streaming add their cases to
    results; deferred keeps in `kept` its last backbuffer, its first timed
    one and its launches, which the aa_ paths and the host_subsystems
    phase read).  The streaming path renders its frames through
    stream_frames, the others through chained_frames."""
    import numpy as np
    import torch
    from granite_tpu_torch.kernels import build as K

    cfg, required = MAIN_PATHS[name]
    streaming = name == "streaming"
    baked = name == "baked_env"
    run = stream_frames if streaming else chained_frames
    if streaming:
        files = tempfile.TemporaryDirectory()
        scene, paths = write_streamed_scene(files.name)
    K.reset_launch_counts()
    t0 = time.monotonic()
    if name == "gltf_animated":
        from granite_tpu_torch.app.bench_scene import build_bench_scene
        files = tempfile.TemporaryDirectory()
        scene = write_animated_scene(files.name, build_bench_scene(),
                                     CHARACTERS, SHEET_AT, ANIM_EYE,
                                     ANIM_TARGET)
        app = make_app(cfg, False, "cuda", scene=scene, camera_index=0)
        files.cleanup()
    elif name == "forward_pcf":
        app = forward_pcf_app(cfg)
    elif name in ("occlusion", "cascades"):
        app = walkthrough_app(cfg)
    elif streaming:
        app = make_app(cfg, False, "cuda", scene=scene)
    else:
        app = make_app(cfg, True, "cuda")
    if baked:
        # the bake's seconds are printed apart, not set-up (its torch ops
        # launch no kernel of the port)
        t_bake = time.monotonic()
        default_env = app.environment
        files = tempfile.TemporaryDirectory()
        app.environment = bake_environment(app, files.name)
        files.cleanup()
        t0 += time.monotonic() - t_bake
    app.swapchain_updated(WIDTH, HEIGHT)
    if name == "decals_meshlet":
        # the check's frames and re-bake are not set-up: the set-up
        # seconds stay comparable with the other paths'
        t_check = time.monotonic()
        decal_check(app)
        t0 += time.monotonic() - t_check
    if streaming:
        # frame 0 and the frames to full residency are its warm-up
        frame0 = streaming_warmup(app)
        warmup = "the frames to residency"
    else:
        app.render_frames_chained(FRAME_TIME, 0.0, WARMUP,
                                  camera_orbit=ORBIT)
        warmup = f"{WARMUP} warm-up frames"
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Each kernel's launches in each timed frame: the render graph runs
    # once a frame, and a wrapper counts its launch on the host as it
    # enqueues; it keeps each frame's backbuffer (the chain's checksum is
    # held against them) and compaction capacity; under occlusion culling
    # also each frame's cull counts (on the device) and its params and
    # history
    frames, culls, visible, last, outs, caps = [], [], [], {}, [], []
    execute = app.graph.execute

    def counted(params, history):
        before = dict(K.LAUNCHES)
        result = execute(params, history)
        frames.append({k: K.LAUNCHES[k] - before[k] for k in before})
        outs.append(result[0])
        caps.append(app._resolved_max_visible())
        last["params"], last["history"] = params, history
        last.setdefault("view_proj", []).append(params.get("view_proj"))
        if app.config.occlusion_culling:
            culls.append(dict(app.cull_counts))
            visible.append((params, history, result[0]))
        return result

    app.graph.execute = counted
    setup_launches = dict(K.LAUNCHES)
    phase0 = app._jitter.phase if app._jitter is not None else None
    t1 = time.monotonic()
    start.record()
    out = run(app, FRAMES)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.monotonic() - t1) * 1e3 / FRAMES
    ms = start.elapsed_time(end) / FRAMES
    launches = dict(K.LAUNCHES)
    del app.graph.execute
    if not streaming:
        checksum_check(app, name, outs)
    if name == "deferred":
        # the aa_ paths' yardsticks (and the host_subsystems phase's pyro
        # frames, the last backbuffer)
        kept.update(deferred_still=outs[0].cpu(),
                    deferred_setup=setup_launches, deferred_frames=frames)
    del outs
    b1_frames = [f["B1"] for f in frames]
    busy_ms, ranges = device_busy_ms(app, TRACED_FRAMES, run)
    img = out.cpu().numpy()
    if name == "deferred":
        kept[name] = img
    ok, means = image_gate(img)
    stats = app.frame_stats()
    # Under TAA render_frames_chained ignores camera_orbit, as the
    # reference's chained TAA does: a still camera, only the jitter moves.
    camera = "still, jittered" if app._jitter is not None else "orbiting"
    loop = "render_frame + post_frame" if streaming else "chained"
    log(f"main path {name} {WIDTH}x{HEIGHT} (renders {app._rw}x{app._rh}):"
        f" {ms:.3f} ms/frame (CUDA events), {host_ms:.3f} ms/frame (host "
        f"clock) over {FRAMES} {loop} frames, camera {camera}; setup + "
        f"{warmup} {setup_s:.1f} s; device busy {busy_ms:.3f} "
        f"ms/frame over {TRACED_FRAMES} traced frames, idle share "
        f"{1.0 - busy_ms / ms:.3f} of the untraced frame")
    log(f"image gate ok={ok} rgb means {means} shape {img.shape} "
        f"nan={int(np.isnan(img.astype(np.float32)).sum())}")
    log(f"device ms a frame by range {name} "
        f"{ {k: round(v, 4) for k, v in sorted(ranges.items())} }")
    log(f"launches {name} {launches}; B1 in each of the {FRAMES} timed "
        f"frames {b1_frames}; B2/B3/B4 in each "
        f"{[(f['B2'], f['B3'], f['B4']) for f in frames]}")
    # max_bin_entries and the overflow/clamp counters: printed, gated only
    # on the time-varying paths (the reference clamps and drops the same
    # way; the port counts)
    log(f"raster stats {stats}")
    if name == "ocean_ground":
        time_check(app, stats, "ocean", 5.0)
    if name == "occlusion":
        occlusion_check(app, stats, b1_frames, culls, visible)
        del culls, visible
    if name == "volumetric":
        volumes_check(app)
    if name == "cascades":
        cascades_check(app, stats, frames, last["params"], results)
    if name == "msaa":
        msaa_check(app, frames, results)
    if streaming:
        streaming_check(app, frames, frame0, last["params"], results,
                        scene, paths)
        files.cleanup()
    if baked:
        baked_env_check(app, default_env, last["params"], results)
    if name == "auto_halfspec":
        auto_halfspec_check(app, caps, last["params"], results)
    if name == "forward_pcf":
        forward_pcf_check(app, stats, frames, setup_launches, launches)
    if name.startswith("aa_"):
        aa_check(app, name, cfg["postAA"], frames, setup_launches, ranges,
                 last, phase0, out, kept)
    del last
    if name == "gltf_animated":
        check(len(b1_frames) == FRAMES and min(b1_frames) >= 1,
              f"B1 launches in the {FRAMES} timed frames: {b1_frames}")
        time_check(app, stats, "animation", 1.0)
        # host side of a frame: pose, palette, culling, params, uploads
        t = time.monotonic()
        for i in range(4):
            app.animation_system.animate(i * FRAME_TIME)
            app.build_frame_params(FRAME_TIME, i * FRAME_TIME)
        log(f"gltf_animated: {len(app.info.animations)} animations, "
            f"{len(app.info.skins)} skins, {app.packed.num_objects} objects,"
            f" {int(app.packed.indices.shape[0])} triangles; host pose + "
            f"params {(time.monotonic() - t) * 1e3 / 4:.3f} ms/frame")
        add_case(results, "B1", b1_dynamic_case(app))
    check(img.shape == (HEIGHT, WIDTH, 4), f"backbuffer shape {img.shape}")
    check(ok, f"image gate failed: means {means}")
    for k in required:
        check(launches[k] > 0, f"kernel {k} was not launched by the {name} "
              "path")
    del app
    torch.cuda.empty_cache()
    return launches


def checksum_check(app, name: str, outs: list) -> None:
    """The chain's checksum against its frames: the float32 sum the chain
    kept on the device against the float64 sum of the backbuffers of the
    timed frames but the last, within CHECKSUM_REL_GATE relative."""
    import torch
    chk = float(app._last_chain_checksum)
    want = sum(float(o.to(torch.float64).sum()) for o in outs[:-1])
    rel = abs(chk - want) / max(abs(want), 1.0)
    log(f"chain checksum {name}: {chk:.9g} over {len(outs) - 1} of its "
        f"{len(outs)} frames, the frames' float64 sum {want:.9g} "
        f"(relative difference {rel:.3g})")
    check(len(outs) == FRAMES and rel <= CHECKSUM_REL_GATE,
          f"{name}'s chain checksum {chk} against its frames' sum {want}")


def auto_halfspec_check(app, caps: list, params, results: dict) -> None:
    """auto_halfspec's gates after its timed frames.  The capacity auto
    chose in each timed frame (0: the bench orbit sees every triangle, so
    no compaction); then the wall view on a new viewer (auto never leaves
    0 once there): its capacity strictly between 0 and the scene total,
    one frame at 1920x1080 through it (B2 launched, no triangle dropped),
    bit-equal to the same frame uncapped; B2 at that capacity against its
    plain version; and B3's environment fetch at the half-res shape of the
    last timed frame's inputs against its plain version."""
    import numpy as np
    import torch
    from granite_tpu_torch.kernels import build as K
    from granite_tpu_torch.renderer import scene_renderer as SR
    from granite_tpu_torch.renderer.environment import env_fetch_coords
    total = int(app.packed.indices.shape[0])
    log(f"auto_halfspec: compaction capacity in each timed frame "
        f"{[c or 0 for c in caps]} (0: no compaction), compaction on in "
        f"{sum(c is not None for c in caps)} of {len(caps)}; the scene's "
        f"{total} triangles")
    planes, cov, _b2 = b2_case(app, params, WIDTH, HEIGHT)
    surf = surface(app, planes, cov)
    refl, lod = SR.reflection(surf, params["camera_pos"],
                              app.environment.num_levels)
    refl, lod, hcov = SR.half_res_inputs(refl, lod, surf["covered"])
    strips = app.environment.strips
    eb, eu, ev = env_fetch_coords(strips, refl, hcov)
    add_case(results, "B3", b3_case(
        f"environment f32 C=4 half-res {WIDTH // 2}x{HEIGHT // 2}",
        (strips, eb, eu, ev, lod, 4)))
    del planes, cov, surf
    if not all(c is None for c in caps):
        return
    wall = make_app(AUTO_CONFIG, True, "cuda")
    wall.camera.look_at(np.asarray(WALL_EYE, np.float32),
                        np.asarray(WALL_TARGET, np.float32))
    wall.swapchain_updated(WIDTH, HEIGHT)
    b2 = K.LAUNCHES["B2"]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    capped = wall.render_frame(FRAME_TIME, 0.0).clone()
    end.record()
    torch.cuda.synchronize()
    cap = wall._resolved_max_visible()
    stats = wall.frame_stats()["gbuffer"]
    b2 = K.LAUNCHES["B2"] - b2
    wall.config.raster_max_visible = 0
    wall.reset_history()
    full = wall.render_frame(FRAME_TIME, 0.0)
    torch.cuda.synchronize()
    same = bool(torch.equal(capped, full))
    log(f"auto_halfspec wall view {WALL_EYE} -> {WALL_TARGET}: capacity "
        f"{cap} of {total} triangles, frame {start.elapsed_time(end):.3f} "
        f"ms (CUDA events, a cold frame), B2 {b2}, gbuffer stats {stats};"
        f" bit-equal to the frame uncapped: {same}")
    check(cap is not None and 0 < cap < total,
          f"auto chose {cap} on the wall view")
    check(b2 >= 1 and stats["visible_overflow"] == 0,
          f"the wall view's frame: B2 {b2}, stats {stats}")
    ok, means = image_gate(capped.cpu().numpy())
    check(ok and same, f"the wall view's frame: gate {ok} {means}, "
          f"bit-equal to uncapped {same}")
    wall.config.raster_max_visible = "auto"
    params = wall.build_frame_params(FRAME_TIME)
    _planes, _cov, case = b2_case(wall, params, WIDTH, HEIGHT,
                                  max_visible=cap)
    case["case"] += f" wall view, auto capacity {cap}"
    add_case(results, "B2", case)
    del wall, params, _planes, _cov
    torch.cuda.empty_cache()


def forward_pcf_app(cfg: dict):
    """forward_pcf's viewer: the bench scene written as .gltf by the port's
    exporter (KHR_lights_punctual for its lights) and loaded through the
    viewer's scene argument, the camera framing its bounds as the bench
    viewer's does; prints what the viewer took from the file."""
    from granite_tpu_torch.app.bench_scene import build_bench_scene
    from granite_tpu_torch.scene_export import export_gltf
    files = tempfile.TemporaryDirectory()
    path = os.path.join(files.name, "bench.gltf")
    t = time.monotonic()
    export_gltf(build_bench_scene(), path)
    write_s = time.monotonic() - t
    app = make_app(cfg, False, "cuda", scene=path)
    files.cleanup()
    kinds = dict(collections.Counter(light.type for light in app.info.lights))
    log(f"forward_pcf: bench scene written as .gltf in {write_s:.2f} s; "
        f"the viewer took {int(app.packed.indices.shape[0])} triangles, "
        f"{len(app.info.meshes)} meshes, {app.packed.num_objects} objects "
        f"and {len(app.info.lights)} lights (by type {kinds}; "
        f"{len(app._positional_lights())} positional) from the file")
    return app


def forward_pcf_check(app, stats: dict, frames: list, setup: dict,
                      launches: dict) -> None:
    """forward_pcf's gates: B1 at set-up (the static 2048^2 sun map) and in
    no timed frame (the cached map), B2, B3 and B4 in every timed frame,
    B3T never (the sun term is the PCF, not VSM), every raster counter 0."""
    per_frame = [(f["B1"], f["B2"], f["B3"], f["B3T"], f["B4"])
                 for f in frames]
    log(f"forward_pcf: B1 {setup['B1']} at set-up; (B1, B2, B3, B3T, B4) in "
        f"each timed frame {per_frame}; B3T in all {launches['B3T']}; the "
        f"sun map {int(app.config.shadow_map_resolution)}^2, VSM "
        f"{app.config.directional_light_shadows_vsm}, graph "
        f"{app.graph._order}")
    check(setup["B1"] >= 1 and setup["B3T"] == 0,
          f"forward_pcf's set-up launches {setup}")
    check(len(frames) == FRAMES and all(
        f["B1"] == 0 and f["B3T"] == 0 and min(f["B2"], f["B3"], f["B4"]) >= 1
        for f in frames), f"forward_pcf's timed frames {per_frame}")
    check(launches["B3T"] == 0, f"forward_pcf launched B3T {launches['B3T']}")
    counters_zero(stats, "forward_pcf")


def aa_check(app, name: str, mode: str, frames: list, setup: dict,
             ranges: dict, last: dict, phase0, out, kept: dict) -> None:
    """An aa_ path's gates.  Its launches at set-up and in each timed frame
    those of the deferred path.  The graph holds the mode's passes: the
    TAA family's taa-resolve before the tonemap, the LDR pass (smaa or
    fxaa) after it, and no other AA pass.  Under the TAA family the jitter
    phase advanced by one a timed frame, each frame's jittered view-proj
    differs from the one before, and the history is live: the last timed
    frame rendered again from its own history is the same within 8 levels
    where, with its taa-history put back to the graph's initial history,
    it differs.  The last backbuffer differs from the deferred path's
    frame from the same camera (the last of the same orbit; the TAA
    chain holds the camera still, so for the TAA family deferred's first
    timed frame, which is unyawed) in >= MIN_CHANGED_SHARE of the
    pixels."""
    import torch
    order = app.graph._order
    taa = mode in TAA_FAMILY
    ldr = LDR_AA_PASS.get(mode)
    tonemap = order.index("tonemap")
    present = [p for p in ("taa-resolve", "fxaa", "smaa") if p in order]
    log(f"{name} ({mode}): AA passes {present} in {order}; device ms a "
        f"frame {({p: round(ranges.get(f'pass:{p}', float('nan')), 4)
                   for p in present})}")
    want = (["taa-resolve"] if taa else []) + ([ldr] if ldr else [])
    check(sorted(present) == sorted(want),
          f"{name}'s AA passes {present}, want {want}")
    check(not taa or order.index("taa-resolve") < tonemap,
          f"{name}: taa-resolve after the tonemap in {order}")
    check(not ldr or order.index(ldr) > tonemap,
          f"{name}: {ldr} before the tonemap in {order}")
    check(setup == kept["deferred_setup"] and frames
          == kept["deferred_frames"], f"{name}'s launches at set-up {setup} "
          f"and a timed frame {frames} are not deferred's "
          f"{kept['deferred_setup']} {kept['deferred_frames']}")
    if taa:
        steps = app._jitter.phase - TRACED_FRAMES - phase0
        vps = last["view_proj"]
        moves = sum(not torch.equal(a, b) for a, b in zip(vps, vps[1:]))
        check(steps == FRAMES and moves == FRAMES - 1,
              f"{name}: the jitter stepped {steps} times in {FRAMES} timed "
              f"frames, the view-proj moved {moves} times")
        params, history = last["params"], last["history"]
        again = app.graph.execute(params, history)[0]
        fresh = dict(history, **{"taa-history": app.graph.initial_history(
            app.device)["taa-history"]})
        reset = app.graph.execute(params, fresh)[0]
        torch.cuda.synchronize()
        still = backbuffer_diff(out, again)
        moved = backbuffer_diff(out, reset)
        log(f"{name}: the last timed frame again from its history differs "
            f"in {still} pixels, from the initial taa-history in {moved} "
            f"(of {WIDTH * HEIGHT}); jitter phase {phase0} -> "
            f"{app._jitter.phase} (the {TRACED_FRAMES} traced frames too) "
            f"over a {len(app._jitter.phases)}-phase table")
        check(moved > 0 and still * 100 <= moved,
              f"{name}'s TAA history is not live ({moved} vs {still} pixels)")
    ref = kept["deferred_still" if taa else "deferred"]
    changed = backbuffer_diff(out.cpu(), torch.as_tensor(ref))
    need = int(MIN_CHANGED_SHARE * WIDTH * HEIGHT) + 1
    log(f"{name}: the last backbuffer differs from deferred's "
        f"{'unyawed first timed' if taa else 'last'} frame in {changed} "
        f"pixels ({changed / (WIDTH * HEIGHT):.4%})")
    check(changed >= need, f"{name} changed {changed} < {need} pixels")


def resident(app) -> bool:
    return all(a.resident for a in app.packed.streamer.manager._assets)


def stream_to_residency(app, sync_each: bool = True, wait_idle=None):
    """From frame 0 on: render_frame (a still camera) then post_frame until
    every asset is resident, at most STREAM_CAP_S.  With sync_each the
    device is idle before each post_frame, so its upload time is the copy
    alone; wait_idle (a ThreadGroup) makes the decodes finish between
    latches.  -> (frame 0, one dict a latch, seconds, frames rendered)."""
    import torch
    st = app.packed.streamer
    latches, first = [], None
    t = time.monotonic()
    while True:
        out = app.render_frame(FRAME_TIME, 0.0)
        if first is None:
            first = out.clone()
        if sync_each:
            torch.cuda.synchronize()
        before = dict(st.stats)
        t_l = time.perf_counter()
        app.post_frame()
        latches.append(dict(
            rows=st.stats["latched"] - before["latched"],
            build_ms=(st.stats["build_s"] - before["build_s"]) * 1e3,
            upload_ms=(st.stats["upload_s"] - before["upload_s"]) * 1e3,
            post_frame_ms=(time.perf_counter() - t_l) * 1e3,
            resident=sum(a.resident for a in st.manager._assets)))
        if wait_idle is not None:
            wait_idle.wait_idle()
        if resident(app):
            return first, latches, time.monotonic() - t, len(latches)
        check(time.monotonic() - t < STREAM_CAP_S,
              f"streaming: {latches[-1]['resident']} of "
              f"{len(st.manager._assets)} assets resident after "
              f"{STREAM_CAP_S} s")


def host_strips(app) -> list:
    """Each bundle's strip as the port's CPU code builds it from the
    scene's files (sidecars where present), apart from the streamer: a
    bundle a thread."""
    from concurrent.futures import ThreadPoolExecutor
    from granite_tpu_torch.assets.streaming import ImageInstantiator
    from granite_tpu_torch.filesystem import AssetClass
    from granite_tpu_torch.renderer.scene_renderer import build_bundle_strip
    st, info = app.packed.streamer, app.info
    inst = ImageInstantiator(info.images, info.image_srgb, info.image_paths,
                             st.base_size)

    def strip(key):
        imgs = []
        for slot, tex in enumerate(key):
            cls = AssetClass.NORMAL if slot == 2 else AssetClass.COLOR
            img = st.tex_to_image.get(tex)
            imgs.append(inst.fallback(cls) if img is None else
                        inst.instantiate(f"img://{img}", cls)[0])
        return build_bundle_strip(imgs)

    with ThreadPoolExecutor(len(st.bundle_keys)) as pool:
        return list(pool.map(strip, st.bundle_keys))


def decode_ms(info, paths) -> dict:
    """Host ms of one image of each sidecar format: the codec's decode
    alone, and the streamer's whole instantiation (decode, sRGB ->
    linear, resize to 512^2)."""
    import numpy as np
    from streaming_fixtures import sidecar_format
    from granite_tpu_torch.assets.streaming import ImageInstantiator
    from granite_tpu_torch.filesystem import AssetClass
    from granite_tpu_torch.native import texture as TX
    inst = ImageInstantiator(info.images, info.image_srgb, paths, 512)
    out: dict = {}
    for i, path in enumerate(paths):
        fmt = sidecar_format(info, i)
        if fmt in out:
            continue
        t = time.perf_counter()
        name, w, h, _l, _f, payload = TX.gtpx_load(path + ".gtpx")
        data = np.frombuffer(payload, np.uint8)
        if name == "bc6h":
            TX.decode_bc6h(data, w, h)
        elif name != "rgba8":
            TX.decode_blocks(name, data, w, h)
        t1 = time.perf_counter()
        inst.instantiate(f"img://{i}", AssetClass.COLOR)
        out[fmt] = dict(decode_ms=(t1 - t) * 1e3,
                        instantiate_ms=(time.perf_counter() - t1) * 1e3)
    return out


def write_streamed_scene(directory: str) -> tuple[str, list]:
    """The streaming path's scene: the bench scene as glTF with
    STREAM_IMAGE^2 images and their .gtpx sidecars; prints the write's and
    the encodes' seconds and each format's host decode ms.  -> (the glTF
    path, each image's file)."""
    from streaming_fixtures import image_files, write_textured_scene
    from granite_tpu_torch.app.bench_scene import build_bench_scene
    t0 = time.monotonic()
    info = build_bench_scene()
    written = write_textured_scene(info, directory, "bench.gltf",
                                   STREAM_IMAGE, STREAM_SEED)
    write_s = time.monotonic() - t0
    paths = image_files(written["path"], len(info.images))
    decodes = decode_ms(info, paths)
    log(f"streaming set-up: scene written (glTF + {len(paths)} PNGs "
        f"{STREAM_IMAGE}^2) in {written['export_s']:.2f} s, sidecars in "
        f"{written['sidecars_s']:.2f} s (wall, one encode a thread; encode "
        "s summed by format "
        f"{ {k: round(v, 3) for k, v in written['encode_s'].items()} }), "
        f"{write_s:.2f} s in all with the images")
    per_format = {k: (round(v["decode_ms"], 2), round(v["instantiate_ms"], 2))
                  for k, v in decodes.items()}
    log(f"streaming host ms for one {STREAM_IMAGE}^2 image by format "
        f"(decode alone, whole instantiation to 512^2): {per_format}")
    return written["path"], paths


def streaming_warmup(app):
    """Phase a up to residency: frame 0's bundle rows must be the fallback
    strip; then stream_to_residency, each latch's rows, strip build and
    upload ms printed.  -> frame 0's backbuffer."""
    import torch
    st = app.packed.streamer
    fallback = torch.from_numpy(st.fallback_strip()).to(app.device)
    check(all(torch.equal(row, fallback) for row in app.packed.bundles),
          "frame 0's bundle rows are not the fallback strip")
    frame0, latches, res_s, res_frames = stream_to_residency(app)
    table = [(l["rows"], round(l["build_ms"], 1), round(l["upload_ms"], 1),
              round(l["post_frame_ms"], 1), l["resident"]) for l in latches]
    log(f"streaming phase a: all {len(st.manager._assets)} assets resident "
        f"after {res_frames} frames, {res_s:.2f} s; latches (rows, build "
        f"ms, upload ms, post_frame ms, resident) {table}")
    rows = sum(l["rows"] for l in latches)
    log(f"streaming latch host ms a bundle row: strip build "
        f"{sum(l['build_ms'] for l in latches) / rows:.2f}, upload "
        f"{sum(l['upload_ms'] for l in latches) / rows:.2f} ({rows} rows, "
        f"{st.fallback_strip().nbytes / 2**20:.1f} MiB each)")
    return frame0


def streaming_check(app, frames: list, frame0, params, results: dict,
                    scene: str, paths: list) -> None:
    """The streaming path's gates after phase a's timed frames: B2 once,
    B3 twice and B4 once in each; every bundle row on the card byte-equal
    to the host strip; the resident frame differs from frame 0; B2 and
    both B3 fetches against their plain versions on the last timed
    frame's inputs (the material fetch reads the streamed rows); then
    phase b and the scene without sidecars."""
    import torch
    per_frame = [(f["B2"], f["B3"], f["B4"]) for f in frames]
    check(len(per_frame) == FRAMES and all(f == (1, 2, 1) for f in per_frame),
          f"B2/B3/B4 launches in the timed frames: {per_frame}")
    want = host_strips(app)
    for b, strip in enumerate(want):
        check(app.packed.bundles[b].cpu().numpy().tobytes()
              == strip.tobytes(),
              f"streamed bundle row {b} differs from the host strip")
    app.reset_history()
    changed = backbuffer_diff(frame0, app.render_frame(FRAME_TIME, 0.0),
                              levels=0)
    log(f"streaming: the resident frame differs from frame 0 in {changed} "
        f"pixels; {len(want)} bundle rows byte-equal to the host strips")
    check(changed >= int(MIN_CHANGED_SHARE * WIDTH * HEIGHT) + 1,
          f"the resident frame differs from frame 0 in {changed} pixels")
    planes, cov, _b2 = b2_case(app, params, WIDTH, HEIGHT)
    surf = surface(app, planes, cov)
    for c in b3_main_cases(app, params, planes, cov, surf,
                           f"streamed rows {WIDTH}x{HEIGHT}"):
        add_case(results, "B3", c)
    del planes, cov, surf
    streaming_budget(scene)
    streaming_without_sidecars(scene, paths)
    torch.cuda.empty_cache()


def streaming_budget(scene: str) -> None:
    """Phase b: a new viewer at textureBudgetMB STREAM_BUDGET_MB,
    STREAM_BUDGET_FRAMES frames of render_frame + post_frame: current_cost
    within the budget after every iterate(), at least one eviction, every
    frame through the image gate."""
    import torch
    app = make_app({**STREAM_CONFIG, "textureBudgetMB": STREAM_BUDGET_MB},
                   False, "cuda", scene=scene)
    app.swapchain_updated(WIDTH, HEIGHT)
    st = app.packed.streamer
    manager = st.manager
    costs, iterate = [], manager.iterate

    def iterate_checked():
        iterate()
        costs.append(manager.current_cost)

    manager.iterate = iterate_checked
    evictions, latched, outs = [], [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t = time.monotonic()
    for i in app._orbit(STREAM_BUDGET_FRAMES, ORBIT):
        e0, l0 = manager.evictions, st.stats["latched"]
        outs.append(app.render_frame(FRAME_TIME, i * FRAME_TIME))
        app.post_frame()
        evictions.append(manager.evictions - e0)
        latched.append(st.stats["latched"] - l0)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.monotonic() - t) * 1e3 / STREAM_BUDGET_FRAMES
    ms = start.elapsed_time(end) / STREAM_BUDGET_FRAMES
    gates = [image_gate(o.cpu().numpy()) for o in outs]
    budget = STREAM_BUDGET_MB * 2**20
    log(f"streaming phase b (textureBudgetMB {STREAM_BUDGET_MB}): "
        f"{ms:.3f} ms/frame (CUDA events), {host_ms:.3f} ms/frame (host "
        f"clock) over {STREAM_BUDGET_FRAMES} frames; rows latched a frame "
        f"{latched}, evictions a frame {evictions}; current_cost after each"
        f" iterate (MiB) {[round(c / 2**20, 1) for c in costs]}; "
        f"{sum(a.resident for a in manager._assets)} resident at the end")
    check(all(c <= budget for c in costs),
          f"current_cost over the budget: {costs}")
    check(manager.evictions >= 1, "phase b evicted nothing")
    check(all(g[0] for g in gates),
          f"phase b image gate failed: {[g[1] for g in gates if not g[0]]}")


def streaming_without_sidecars(scene: str, paths: list) -> None:
    """The sidecars deleted, the scene streamed to residency renders
    bit-equal to it with textureStreaming false (the same bundle bytes
    through the same kernels)."""
    import torch
    for path in paths:
        os.unlink(path + ".gtpx")
    imgs, bundles = {}, {}
    for label, cfg in (("streamed", STREAM_CONFIG),
                       ("unstreamed", BENCH_CONFIG)):
        app = make_app(cfg, False, "cuda", scene=scene)
        app.swapchain_updated(WIDTH, HEIGHT)
        if label == "streamed":
            stream_to_residency(app, sync_each=False)
            app.reset_history()
        imgs[label] = app.render_frame(FRAME_TIME, 0.0)
        bundles[label] = app.packed.bundles
        del app
    same_rows = torch.equal(bundles["streamed"], bundles["unstreamed"])
    same_frame = torch.equal(imgs["streamed"], imgs["unstreamed"])
    differ = backbuffer_diff(imgs["streamed"], imgs["unstreamed"], levels=0)
    log(f"streaming without sidecars, resident, against textureStreaming "
        f"false: bundles equal {same_rows}, frames equal {same_frame} "
        f"({differ} pixels differ)")
    check(same_rows and same_frame,
          "streaming without sidecars is not bit-equal to no streaming")


def streaming_cross_device() -> None:
    """The small streamed test scene (four STREAM_SMALL_IMAGE^2 images a
    material, sidecars, deferred_hdr) at 128x72, resident, on the card
    and on the CPU: each device latches until every asset is resident
    (its decodes finishing between latches), then renders 2 frames from
    a fresh history; luma PSNR >= 48 dB."""
    import torch
    from golden_utils import CONFIGS, psnr
    from streaming_fixtures import write_textured_scene
    from granite_tpu_torch.app.bench_scene import build_default_test_scene
    from granite_tpu_torch.threading_ import ThreadGroup
    files = tempfile.TemporaryDirectory()
    path = write_textured_scene(build_default_test_scene(), files.name,
                                "small.gltf", STREAM_SMALL_IMAGE,
                                STREAM_SEED)["path"]
    cfg = {**CONFIGS["deferred_hdr"], "textureStreaming": True,
           "materialTileSampler": "true"}
    imgs = {}
    for device in ("cuda", "cpu"):
        app = make_app(cfg, False, device, scene=path)
        app.swapchain_updated(128, 72)
        stream_to_residency(app, sync_each=False,
                            wait_idle=ThreadGroup.get())
        app.reset_history()
        out = None
        for i in range(2):
            out = app.render_frame(FRAME_TIME, i * FRAME_TIME)
        imgs[device] = out.cpu().numpy()
    files.cleanup()
    p = psnr(imgs["cuda"], imgs["cpu"])
    log(f"cross-device deferred_hdr streamed textures 128x72: cuda vs cpu "
        f"luma PSNR {p:.2f} dB")
    check(p >= PSNR_GATE_DB,
          f"cross-device streamed textures PSNR {p:.2f} < {PSNR_GATE_DB}")


def bake_environment(app, directory: str):
    """baked_env's set-up: the viewer's own sky as .npy, baked by
    `python -m granite_tpu_torch.tools.convert_equirect_to_environment`'s
    entry point at BAKE_SIZE with BAKE_SAMPLES on the card and again on
    the CPU; the card's chain within BAKE_REL_GATE of the CPU's (max abs
    difference over each level's max).  -> the baked Environment (the
    viewer's sky_params kept: the background stays analytic)."""
    import numpy as np
    import torch
    from granite_tpu_torch.renderer.environment import (
        Environment, load_baked_environment, procedural_sky_equirect,
    )
    from granite_tpu_torch.tools import convert_equirect_to_environment as CE
    sky = app.environment.sky_params
    src = os.path.join(directory, "sky.npy")
    np.save(src, procedural_sky_equirect(128, **sky))
    bakes, seconds = {}, {}
    for device in ("cuda", "cpu"):
        path = os.path.join(directory, f"sky_{device}.genv.npz")
        torch.cuda.synchronize()
        t = time.monotonic()
        rc = CE.main([src, "--output", path, "--size", str(BAKE_SIZE),
                      "--samples", str(BAKE_SAMPLES), "--device", device])
        torch.cuda.synchronize()
        seconds[device] = time.monotonic() - t
        check(rc == 0, f"the environment bake on {device} exited {rc}")
        bakes[device] = load_baked_environment(path)
    card, cpu = bakes["cuda"], bakes["cpu"]
    abs_err = max(float(np.abs(a - b).max())
                  for a, b in zip(card["reflection"], cpu["reflection"]))
    rel_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                  for a, b in zip(card["reflection"], cpu["reflection"]))
    texel_rel = max(float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30))
                          .max())
                    for a, b in zip(card["reflection"], cpu["reflection"]))
    env = Environment(procedural_sky_equirect(128, **sky), sky_params=sky,
                      baked=card, device=app.device)
    log(f"baked_env set-up: sky {BAKE_SIZE}^2 x {len(card['reflection'])} "
        f"levels, {BAKE_SAMPLES} samples: bake {seconds['cuda']:.3f} s on "
        f"the card, {seconds['cpu']:.3f} s on the CPU; card vs CPU max abs "
        f"err {abs_err:.3g}, max rel err {rel_err:.3g} of a level's "
        f"magnitude ({texel_rel:.3g} of a texel's own value); sh equal "
        f"{bool(np.array_equal(card['sh'], cpu['sh']))}; strip "
        f"{tuple(env.strips.shape)} (default "
        f"{tuple(app.environment.strips.shape)})")
    check(rel_err <= BAKE_REL_GATE,
          f"the card's bake differs from the CPU's by {rel_err}")
    check(env.strips.shape == app.environment.strips.shape
          and env.num_levels == app.environment.num_levels,
          "the baked strip's shape differs from the bench strip's")
    return env


def baked_env_check(app, default_env, params, results: dict) -> None:
    """baked_env's gates after its timed frames: the frame from a fresh
    history differs from the default environment's frame from the same
    camera and history in >= MIN_CHANGED_SHARE of the pixels; B3's
    environment fetch on the last timed frame's inputs against its plain
    version, on the baked strip and on the default strip (the same
    coordinates: both strips are 256 wide)."""
    import torch
    baked_env = app.environment
    frames = {}
    for label, env in (("baked", baked_env), ("default", default_env)):
        app.environment = env
        app.reset_history()
        frames[label] = app.render_frame(FRAME_TIME, 0.0).clone()
    app.environment = baked_env
    changed = backbuffer_diff(frames["baked"], frames["default"], levels=0)
    log(f"baked_env: the baked environment's frame differs from the "
        f"default environment's in {changed} pixels "
        f"({changed / (WIDTH * HEIGHT):.4f})")
    check(changed >= int(MIN_CHANGED_SHARE * WIDTH * HEIGHT) + 1,
          f"the baked environment changes {changed} pixels")
    planes, cov, _b2 = b2_case(app, params, WIDTH, HEIGHT)
    surf = surface(app, planes, cov)
    for env, label in ((baked_env, "baked strip"),
                       (default_env, "default strip, baked_env's inputs")):
        add_case(results, "B3", b3_case(
            f"environment f32 C=4 {label} {WIDTH}x{HEIGHT}",
            b3_env_args(app, params, surf, env.strips)))
    del planes, cov, surf
    torch.cuda.empty_cache()


def run_tool(main, argv: list) -> tuple[int, str, float]:
    """A tool's main(argv) with its standard output captured, the card
    idle at both ends; -> (exit code, output, seconds)."""
    import contextlib
    import io
    import torch
    buf = io.StringIO()
    torch.cuda.synchronize()
    t = time.monotonic()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.monotonic() - t


def tool_json(text: str) -> dict:
    """The JSON object a tool prints last (after its plain lines)."""
    return json.loads(text[text.index("{"):])


def tools_path(directory: str) -> tuple[dict, dict]:
    """Phase tools, its launches counted from 0: the port's tools through
    their entry points on the card (see the module docstring).  -> (its
    launches, its numbers for the kernels line)."""
    import numpy as np
    from golden_utils import psnr
    from streaming_fixtures import write_textured_scene
    from granite_tpu_torch import native as TN
    from granite_tpu_torch.app.bench_scene import build_bench_scene
    from granite_tpu_torch.kernels import build as K
    from granite_tpu_torch.scene.gltf import GLTFParser
    from granite_tpu_torch.tools import (
        aa_bench, brdf_lut_generate, gltf_repacker, hw_verify,
        quality_receipt, sweep_scene,
    )
    from granite_tpu_torch.utils.image_io import load_image
    K.reset_launch_counts()
    out: dict = {}

    # brdf_lut_generate at its defaults on the card; the integration at
    # BRDF_CHECK_SIZE on both devices
    lut_path = os.path.join(directory, "brdf.npy")
    rc, _text, s = run_tool(brdf_lut_generate.main,
                            ["--output", lut_path, "--device", "cuda"])
    lut = np.load(lut_path)
    check(rc == 0 and lut.shape == (256, 256, 2)
          and bool(np.isfinite(lut).all()), "brdf_lut_generate failed")
    err = float(np.abs(
        brdf_lut_generate.integrate_brdf(BRDF_CHECK_SIZE, 512, "cuda")
        - brdf_lut_generate.integrate_brdf(BRDF_CHECK_SIZE, 512, "cpu"))
        .max())
    out["brdf_lut"] = dict(seconds=s, size=256, samples=512,
                           max_abs_err_vs_cpu=err)
    log(f"tools: brdf_lut_generate 256^2 x 512 samples on the card "
        f"{s:.3f} s; at {BRDF_CHECK_SIZE}^2 card vs CPU max abs err "
        f"{err:.3g}; LUT range [{lut.min():.4f}, {lut.max():.4f}]")
    check(err <= BRDF_GATE, f"brdf LUT card vs CPU {err}")

    # hw_verify at the bench resolution (its B2 count is the card's)
    hw_dir = os.path.join(directory, "hw_verify")
    rc, _text, s = run_tool(hw_verify.main, [
        "--width", str(WIDTH), "--height", str(HEIGHT), "--out", hw_dir,
        "--device", "cuda"])
    with open(os.path.join(hw_dir, "hw_verify.json")) as f:
        report = json.load(f)
    log(f"tools: hw_verify {WIDTH}x{HEIGHT} exit {rc} in {s:.1f} s; "
        "report:")
    log(json.dumps(report))
    check(rc == 0 and report["ok"], f"hw_verify failed: "
          f"{report['failures']}")
    check(report["chain_b2_launches"] == report["chain_frames"],
          f"hw_verify's chain launched B2 {report['chain_b2_launches']} "
          "times")
    check(report["chain_checksum"] is not None
          and bool(np.isfinite(report["chain_checksum"])),
          f"hw_verify's chain checksum {report['chain_checksum']}")
    out["hw_verify"] = dict(seconds=s, **{
        k: report[k] for k in ("plane_means", "black_tiles", "chain_frames",
                               "chain_graph_executes", "chain_b2_launches",
                               "chain_checksum", "ok")})

    # quality_receipt at the bench resolution
    rc, text, s = run_tool(quality_receipt.main, [
        "--width", str(WIDTH), "--height", str(HEIGHT), "--out",
        os.path.join(directory, "quality"), "--device", "cuda"])
    receipt = json.loads(text.strip().splitlines()[-1])
    check(rc == 0, f"quality_receipt exited {rc}")
    out["quality_receipt"] = dict(seconds=s, **receipt)
    log(f"tools: quality_receipt {WIDTH}x{HEIGHT} in {s:.1f} s: {receipt}")

    # aa_bench at its defaults but AA_MODES (a viewer process a mode)
    aa_dir = os.path.join(directory, "aa")
    rc, text, s = run_tool(aa_bench.main, ["--modes", *AA_MODES, "--outdir",
                                           aa_dir, "--device", "cuda"])
    aa = tool_json(text)
    check(rc == 0, f"aa_bench exited {rc}")
    for mode in aa:
        ok, means = image_gate(load_image(os.path.join(aa_dir,
                                                       f"{mode}.png")))
        check(ok, f"aa_bench {mode}: image gate failed, means {means}")
    out["aa_bench"] = dict(seconds=s, modes={
        m: dict(us=r["averageFrameTimeUs"], psnr_luma=r.get("psnrLuma"))
        for m, r in aa.items()})
    log(f"tools: aa_bench 640x360 x 16 chained frames, {len(aa)} modes in "
        f"{s:.1f} s: {out['aa_bench']['modes']}")

    # sweep_scene with the bench config at its defaults
    cfg = os.path.join(directory, "bench.json")
    with open(cfg, "w") as f:
        json.dump(BENCH_CONFIG, f)
    rc, text, s = run_tool(sweep_scene.main, [
        "--configs", cfg, "--iterations", str(SWEEP_ITERATIONS),
        "--device", "cuda"])
    sweep = tool_json(text)[cfg]
    check(rc == 0, f"sweep_scene exited {rc}")
    out["sweep_scene"] = dict(seconds=s, **sweep)
    log(f"tools: sweep_scene bench config 1280x720 x 32 frames, "
        f"{SWEEP_ITERATIONS} iterations in {s:.1f} s: {sweep}")

    # gltf_repacker on the streaming path's glTF bench scene (its images
    # without the .gtpx sidecars, which the repacker does not read)
    src_dir, rep_dir = (os.path.join(directory, d) for d in ("src", "rep"))
    os.makedirs(src_dir)
    os.makedirs(rep_dir)
    src = write_textured_scene(build_bench_scene(), src_dir, "bench.gltf",
                               STREAM_IMAGE, STREAM_SEED,
                               sidecars=False)["path"]
    rep = os.path.join(rep_dir, "bench.gltf")
    rc, text, s = run_tool(gltf_repacker.main, [
        "--input", src, "--output", rep, "--meshlets",
        "--compress-textures"])
    check(rc == 0, f"gltf_repacker exited {rc}")
    lines = text.splitlines()
    vertices = lines[0]
    meshlets = sum(int(line.split()[1]) for line in lines
                   if line.strip().startswith("mesh"))
    textures = sum(1 for line in lines if line.strip().startswith("tex"))
    # every mesh of the repacked file through MLT1 and back: each decoded
    # triangle is its source triangle, within a 16-bit step of the extent
    decoded, worst = 0, 0.0
    for md in GLTFParser(rep).get_scene().meshes:
        blob, n = TN.meshlet_encode(md.positions, md.indices)
        pos, idx = TN.meshlet_decode(blob, n, 3 * len(md.indices),
                                     len(md.indices))
        step = (md.positions.max(0) - md.positions.min(0)) / 65535.0
        d = np.abs(md.positions[md.indices] - pos[idx])
        check(idx.shape == md.indices.shape and bool((d <= step + 1e-6)
                                                     .all()),
              "an MLT1 decode is off its input by more than a step")
        worst = max(worst, float((d / np.maximum(step, 1e-30)).max()))
        decoded += n
    check(decoded == meshlets, f"MLT1 meshlets {decoded} != the tool's "
          f"{meshlets}")
    frames = {}
    for label, path in (("source", src), ("repacked", rep)):
        app = make_app(BENCH_CONFIG, False, "cuda", scene=path)
        app.swapchain_updated(WIDTH, HEIGHT)
        frames[label] = app.render_frame(FRAME_TIME, 0.0).cpu().numpy()
        del app
        ok, means = image_gate(frames[label])
        check(ok, f"the {label} glTF frame fails the image gate: {means}")
    p = float(psnr(frames["repacked"], frames["source"]))
    out["gltf_repacker"] = dict(seconds=s, vertices=vertices,
                                meshlets=meshlets, textures=textures,
                                decode_max_steps=worst, psnr_vs_source=p)
    log(f"tools: gltf_repacker --meshlets --compress-textures on the bench "
        f"glTF ({STREAM_IMAGE}^2 images) in {s:.1f} s: {vertices}; "
        f"{meshlets} MLT1 meshlets (decoded within {worst:.3f} of a step); "
        f"{textures} .gtpx; the repacked scene's {WIDTH}x{HEIGHT} frame vs "
        f"the source's: luma PSNR {p:.2f} dB")
    launches = dict(K.LAUNCHES)
    log(f"launches tools {launches}")
    return launches, out


def host_physics() -> dict:
    """The two-box stack and a sphere dropped on the plane for PHYSICS_S,
    through the port's PhysicsSystem on the port's Scene."""
    import numpy as np
    from granite_tpu_torch.event.manager import EventManager
    from granite_tpu_torch.physics import (
        CollisionEvent, InteractionType, MaterialInfo, PhysicsSystem,
    )
    from granite_tpu_torch.scene.scene import Scene
    EventManager.reset()
    events, ticks = [], []
    EventManager.get().register_handler(CollisionEvent, events.append)
    world = PhysicsSystem()
    world.tick_callback = ticks.append
    scene = Scene()
    world.set_scene(scene)
    floor = world.add_infinite_plane(
        [0.0, 1.0, 0.0, 0.0],
        MaterialInfo(type=InteractionType.Static, friction=0.8))
    boxes = [world.add_cube(scene.create_node(translation=t,
                                              scale=[0.5] * 3),
                            MaterialInfo(mass=1.0, restitution=0.0,
                                         friction=0.9))
             for t in ([0.0, 0.5, 0.0], [0.05, 1.55, 0.0])]
    ball = world.add_sphere(scene.create_node(translation=[4.0, 1.6, 0.0]),
                            MaterialInfo(mass=1.0, restitution=0.0))
    t = time.monotonic()
    for _ in range(round(PHYSICS_S / PHYSICS_STEP)):
        world.iterate(PHYSICS_STEP)
        EventManager.get().dispatch()
    secs = time.monotonic() - t
    EventManager.reset()
    b0, b1, bs = (world._bodies[h.index] for h in (*boxes, ball))
    pairs = {frozenset((e.get_first_handle().index,
                        e.get_second_handle().index)) for e in events}
    out = dict(ticks=len(ticks), ms_a_tick=secs * 1e3 / len(ticks),
               seconds=secs, events=len(events),
               box_y=[float(b0.pos[1]), float(b1.pos[1])],
               sphere_y=float(bs.pos[1]),
               speeds=[float(np.linalg.norm(b.linvel)) for b in (b0, b1, bs)])
    log(f"host physics: {out['ticks']} ticks of 1/300 s in {secs:.3f} s, "
        f"{out['ms_a_tick']:.3f} ms a tick; boxes at y {out['box_y']}, "
        f"sphere at y {out['sphere_y']:.4f}, speeds {out['speeds']}; "
        f"{len(events)} CollisionEvents")
    check(abs(len(ticks) - round(PHYSICS_S * 300)) <= 1,
          f"physics ran {len(ticks)} ticks")
    check(abs(b0.pos[1] - 0.5) < 0.1 and 1.2 < b1.pos[1] < 1.8
          and max(out["speeds"][:2]) < 0.3, "the box stack fell")
    check(abs(bs.pos[1] - 1.0) < 0.05 and out["speeds"][2] < 0.1,
          "the sphere does not rest on the plane")
    want = {frozenset((floor.index, ball.index)),
            frozenset((floor.index, boxes[0].index)),
            frozenset((boxes[0].index, boxes[1].index))}
    check(want <= pairs, f"CollisionEvent pairs {pairs} lack {want - pairs}")
    return out


def host_audio(directory: str) -> dict:
    """Every mixer slot busy: 127 seeded sines and one WAV stream, mixed
    through WavFileBackend for AUDIO_S."""
    import wave
    import numpy as np
    from granite_tpu_torch.audio import (
        Mixer, SineStream, WavFileBackend, WavStream,
    )
    from granite_tpu_torch.audio.mixer import MAX_SOURCES
    rng = np.random.default_rng(HOST_SEED)
    src, dst = (os.path.join(directory, f) for f in ("src.wav", "mix.wav"))
    n = int(AUDIO_WAV_S * 44100)
    tone = 0.5 * np.sin(2 * np.pi * 220.0 * np.arange(n) / 44100.0)
    pcm = np.stack([tone, rng.uniform(-0.2, 0.2, n)], 1) * 32767
    with wave.open(src, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(44100)
        w.writeframes(pcm.astype(np.int16).tobytes())
    m = Mixer()
    be = WavFileBackend(dst, m, sample_rate=float(AUDIO_RATE),
                        block_frames=AUDIO_BLOCK)
    ids = [m.add_mixer_stream(SineStream(float(rng.uniform(40, 8000))),
                              initial_gain_db=float(rng.uniform(-48, -36)),
                              initial_panning=float(rng.uniform(-1, 1)))
           for _ in range(MAX_SOURCES - 1)]
    wav_id = m.add_mixer_stream(WavStream(src), initial_gain_db=-6.0)
    full = m.add_mixer_stream(SineStream(1.0))
    check(min(ids + [wav_id]) >= 0 and full == -1,
          f"mixer slots: a stream refused, or a {MAX_SOURCES + 1}th taken")
    frames = int(AUDIO_S * AUDIO_RATE)
    blocks = -(-frames // AUDIO_BLOCK)
    t = time.monotonic()
    be.render(AUDIO_S)
    secs = time.monotonic() - t
    messages = []
    q = m.get_message_queue()
    while not q.empty():
        messages.append(q.get_nowait())
    with wave.open(dst, "rb") as w:
        shape = (w.getnframes(), w.getnchannels(), w.getsampwidth(),
                 w.getframerate())
        mix = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    rms = float(np.sqrt(np.mean(mix.astype(np.float64) ** 2)) / 32768.0)
    out = dict(streams=MAX_SOURCES, blocks=blocks, seconds=secs,
               ms_a_block=secs * 1e3 / blocks,
               audio_ms_a_block=AUDIO_BLOCK * 1e3 / AUDIO_RATE, rms=rms,
               messages=[list(x) for x in messages])
    log(f"host audio: {MAX_SOURCES} streams, {blocks} blocks of "
        f"{AUDIO_BLOCK} frames in {secs:.3f} s: {out['ms_a_block']:.3f} ms "
        f"a block against {out['audio_ms_a_block']:.3f} ms of audio; file "
        f"{shape}, rms {rms:.4f}; messages {messages}")
    check(shape == (frames, 2, 2, AUDIO_RATE), f"mix file {shape}")
    check(rms > 0.01, f"the mix is silent (rms {rms})")
    check(messages == [("stream_stopped", wav_id)],
          f"stream_stopped messages {messages}, want the WAV's {wav_id}")
    return out


def host_netfs() -> dict:
    """A NETFS_BLOB_BYTES blob and small files through NetfsServer and
    NetfsBackend mounted in the port's Filesystem, on loopback."""
    import numpy as np
    from granite_tpu_torch.filesystem.vfs import Filesystem, MemoryBackend
    from granite_tpu_torch.network import NetfsBackend, NetfsServer
    rng = np.random.default_rng(HOST_SEED)
    blob = rng.bytes(NETFS_BLOB_BYTES)
    files = {"strips/row0.bin": blob, "scene/info.json": b'{"rows": 1}',
             "scene/table.bin": rng.bytes(4096)}
    store = MemoryBackend(files)
    srv = NetfsServer(store)
    srv.start()
    try:
        fs = Filesystem()
        fs.register_protocol("netfs", NetfsBackend("127.0.0.1", srv.port))
        for path, data in files.items():
            if len(data) < 1 << 20:
                check(fs.read_file("netfs://" + path) == data,
                      f"netfs read of {path} differs")
        check(fs.list_dir("netfs://scene") == ["info.json", "table.bin"]
              and fs.stat("netfs://strips/row0.bin")["size"] == len(blob),
              "netfs list or stat differs")
        check(fs.write_file("netfs://scene/new.bin", b"\1\2")
              and store.files["scene/new.bin"] == b"\1\2",
              "netfs write lost")
        rates = []
        for _ in range(NETFS_READS):
            t = time.monotonic()
            got = fs.read_file("netfs://strips/row0.bin")
            rates.append(len(blob) / (time.monotonic() - t) / 1e6)
            check(got == blob, "the netfs blob came back different")
            del got
    finally:
        srv.stop()
    out = dict(bytes=len(blob), mb_per_s=rates,
               median_mb_per_s=float(np.median(rates)))
    log(f"host netfs: {len(blob)} bytes read back byte-equal "
        f"{NETFS_READS} times at {[round(r, 1) for r in rates]} MB/s")
    return out


class LossyLink:
    """Stands in for the pyro server's UDP socket: sendto drops the
    datagram numbered `drop` of the frame being sent and, every PYRO_BATCH
    datagrams, lets the client receive them into its Reassembler (loopback
    UDP loses only what overflows the receive buffer)."""

    def __init__(self, sock, client, datagram_bytes: int):
        self.sock, self.client = sock, client
        self.datagram_bytes = datagram_bytes
        self.index, self.drop, self.in_flight = 0, -1, 0

    def sendto(self, datagram: bytes, addr) -> int:
        self.index += 1
        if self.index - 1 != self.drop:
            self.sock.sendto(datagram, addr)
            self.in_flight += 1
            if self.in_flight == PYRO_BATCH:
                self.drain()
        return len(datagram)

    def drain(self) -> None:
        while self.in_flight:
            data, _ = self.client._udp.recvfrom(self.datagram_bytes)
            check(self.client.reassembler.feed(data) is None,
                  "pyro: a frame completed before its send ended")
            self.in_flight -= 1

    def close(self) -> None:
        self.sock.close()


def host_pyro(frame) -> dict:
    """The port's PyroServer and PyroClient: the handshake, then
    PYRO_FRAMES frames of the deferred backbuffer with FEC and one data
    subpacket dropped a frame."""
    import numpy as np
    from granite_tpu_torch.video.pyro import (
        PYRO_MAX_PAYLOAD_SIZE, VIDEO_CODEC_PYROWAVE, CodecParameters,
        PayloadHeader, PyroClient, PyroServer,
    )
    h, w = frame.shape[:2]
    codec = CodecParameters(video_codec=VIDEO_CODEC_PYROWAVE, width=w,
                            height=h, frame_rate_num=60)
    srv = PyroServer(codec)
    cli = None
    try:
        srv.serve_handshake()
        t = time.monotonic()
        cli = PyroClient("127.0.0.1", srv.tcp_port, srv.udp_port)
        got = cli.handshake()
        srv._thread.join(5.0)
        handshake_ms = (time.monotonic() - t) * 1e3
        check(got == codec and not srv._thread.is_alive()
              and srv._client_addr is not None, f"pyro handshake: {got}")
        cli._udp.settimeout(5.0)
        link = srv._udp = LossyLink(
            srv._udp, cli, PYRO_MAX_PAYLOAD_SIZE + PayloadHeader.SIZE)
        rng = np.random.default_rng(HOST_SEED)
        ms, drops = [], []
        for k in range(PYRO_FRAMES):
            data = np.roll(frame, k * (h // PYRO_FRAMES), axis=0).tobytes()
            n_data = -(-len(data) // PYRO_MAX_PAYLOAD_SIZE)
            # the first subpacket, the short tail, then seeded ones
            link.index = 0
            link.drop = (0, n_data - 1)[k] if k < 2 else \
                int(rng.integers(1, n_data - 1))
            drops.append(link.drop)
            t = time.monotonic()
            srv.send_frame(data, key_frame=k == 0, pts=k * 1000,
                           xor_blocks_even=PYRO_FEC[0],
                           xor_blocks_odd=PYRO_FEC[1])
            link.drain()
            out = cli.reassembler.flush()
            ms.append((time.monotonic() - t) * 1e3)
            check(out == data, f"pyro frame {k} (dropped subpacket "
                  f"{link.drop} of {n_data}) not rebuilt byte-equal")
        r = cli.reassembler
        check(r.total_recovered_packets == PYRO_FRAMES
              and r.total_received_key_frames == 1,
              f"pyro: {r.total_recovered_packets} recovered, "
              f"{r.total_received_key_frames} key frames")
    finally:
        srv.close()
        if cli is not None:
            cli.close()
    result = dict(frames=PYRO_FRAMES, bytes_a_frame=len(data),
                  datagrams_a_frame=n_data + sum(PYRO_FEC),
                  handshake_ms=handshake_ms, ms_a_frame=ms, dropped=drops,
                  median_ms_a_frame=float(np.median(ms)))
    log(f"host pyro: handshake {handshake_ms:.2f} ms; {PYRO_FRAMES} frames "
        f"of {w}x{h} RGBA8 ({len(data)} bytes, {n_data} + {sum(PYRO_FEC)} "
        f"datagrams), subpackets {drops} dropped and recovered, ms a frame "
        f"{[round(x, 1) for x in ms]}")
    return result


def host_subsystems(frame) -> tuple[dict, dict]:
    """Phase host_subsystems (see the module docstring); -> (its launches,
    counted from 0 and all 0, its numbers)."""
    from granite_tpu_torch.kernels import build as K
    K.reset_launch_counts()
    files = tempfile.TemporaryDirectory()
    try:
        out = {"physics": host_physics(), "audio": host_audio(files.name),
               "netfs": host_netfs(), "pyro": host_pyro(frame)}
    finally:
        files.cleanup()
    launches = dict(K.LAUNCHES)
    log(f"launches host_subsystems {launches}")
    check(not any(launches.values()),
          f"the host subsystems launched kernels: {launches}")
    return launches, out


def band_b1_case(mesh, arrays, width: int, height: int, label: str) -> dict:
    """Kernel B1 on this rank's band of the setup `arrays`, binned as
    rasterize_binned_sharded bins it, through b1_case (against the plain
    version, device ms, plain ms, bound).  The ranks take turns (a
    barrier each), so each band is timed alone on the card."""
    import torch.distributed as dist
    from granite_tpu_torch.parallel import dryrun as PD
    from granite_tpu_torch.parallel import sharded_raster as SRD
    setup = PD.setup_from_arrays(arrays, mesh.device)
    band_h = height // mesh.size
    capacity = SRD.default_band_capacity(setup.adj.shape[0], mesh.size)
    case = None
    for r in range(mesh.size):
        if r == mesh.rank:
            args, _, local = SRD.band_raster_args(setup, width, r * band_h,
                                                  band_h, capacity)
            case = b1_case(args, f"{label} band {r} ({width}x{band_h} of "
                           f"{width}x{height}, {int(local.valid.sum())} "
                           "triangles)")
        dist.barrier(group=mesh.group)
    return case


def parallel_rank(mesh, bench_arrays: dict, sphere_arrays: dict) -> dict:
    """One rank of the parallel phase: (a), (b) and (c) of the module
    docstring."""
    from granite_tpu_torch.parallel import dryrun as PD
    out = {}
    for name, arrays, (w, h) in (
            ("bench", bench_arrays, (WIDTH, HEIGHT)),
            ("spheres", sphere_arrays, (SPHERES_W, SPHERES_H))):
        out[name] = PD.raster_leg(mesh, arrays, w, h)
        out[name]["case"] = band_b1_case(mesh, arrays, w, h, name)
    out["frame"] = PD.frame_leg(mesh, BENCH_CONFIG, WIDTH, HEIGHT, WARMUP,
                                PARALLEL_FRAMES, bench_scene=True)
    return out


def parallel_frame_check(ranks: list, label: str) -> dict:
    """(c)'s and (d)'s gates on frame_leg's results (rank order)."""
    import numpy as np
    from granite_tpu_torch.parallel import dryrun as PD
    got = PD.check_frame(ranks, HEIGHT)
    r0 = ranks[0]
    want = r0["reference_launches"]
    check(all(want[k] >= 1 for k in ("B2", "B3", "B4")),
          f"{label}: the unsharded frame launched {want}")
    for r in ranks:
        for i, f in enumerate(r["frames"]):
            check(f["launches"] == want, f"{label}: rank {r['rank']} frame "
                  f"{i} launched {f['launches']}, unsharded {want}")
    ok, means = image_gate(r0["frame"])
    check(ok, f"{label}: image gate failed: means {means}")
    gather_ms = [float(np.mean([c["all_gather"] for c in r["collective_ms"]]))
                 for r in ranks]
    reduce_ms = [float(np.mean([c["all_reduce"] for c in r["collective_ms"]]))
                 for r in ranks]
    banded = [p for p, how in r0["placement"].items()
              if how.startswith(("banded", "reduced"))]
    log(f"parallel {label}: {HEIGHT}x{WIDTH} frame vs unsharded max |diff| "
        f"{got['max_diff']}, mean {got['mean_diff']:.6f}; luminance "
        f"{got['luminance']} on every rank; rank 0 {r0['ms']:.3f} ms/frame "
        f"(CUDA events; host {r0['host_ms']:.3f}) over {len(r0['frames'])} "
        f"frames, set-up + warm-up {r0['setup_s']:.1f} s; all_gather host "
        f"ms a frame by rank {[round(x, 3) for x in gather_ms]}, all_reduce "
        f"{[round(x, 3) for x in reduce_ms]}; collectives a frame "
        f"{r0['frames'][-1]['collectives']}; launches a frame {want}; "
        f"banded or reduced {banded}; placement {r0['placement']}")
    return dict(got, ms=r0["ms"], host_ms=r0["host_ms"],
                setup_s=r0["setup_s"], all_gather_ms=gather_ms,
                all_reduce_ms=reduce_ms, placement=r0["placement"],
                collectives=r0["frames"][-1]["collectives"],
                launches_a_frame=want)


def parallel_phase(results: dict) -> tuple[dict, dict, dict]:
    """Phase parallel (see the module docstring).  -> (the gloo ranks'
    launches summed, the nccl rank's launches, its numbers)."""
    import torch
    from granite_tpu_torch.kernels import build as K
    from granite_tpu_torch.parallel import dryrun as PD
    from granite_tpu_torch.parallel.launch import spawn_ranks
    from granite_tpu_torch.parallel.sharded_raster import band_cull_setup
    from granite_tpu_torch.ops import raster_binned as RB
    from granite_tpu_torch.renderer import scene_renderer as SR
    n = PARALLEL_RANKS
    app = make_app(BENCH_CONFIG, True, "cuda")
    app.swapchain_updated(WIDTH, HEIGHT)
    params = app.build_frame_params(FRAME_TIME, 0.0)
    ext = params["external"]
    clip = SR.transform_vertices(app.packed, ext["world"],
                                 ext["normal_mats"], params["view_proj"])[0]
    every = torch.ones(app.packed.num_objects, dtype=torch.bool,
                       device=clip.device)
    setups = {"bench": (view_setup(app, clip, every, WIDTH, HEIGHT), WIDTH,
                        HEIGHT),
              "spheres": (PD.sphere_field_setup(SPHERES_W, SPHERES_H,
                                                "cuda"),
                          SPHERES_W, SPHERES_H)}
    del app
    torch.cuda.empty_cache()
    t = time.monotonic()
    ranks = spawn_ranks(n, parallel_rank,
                        PD.setup_arrays(setups["bench"][0]),
                        PD.setup_arrays(setups["spheres"][0]),
                        backend="gloo", device="cuda")
    log(f"parallel: {n} gloo ranks on one card took "
        f"{time.monotonic() - t:.1f} s")
    launches = {k: sum(r["frame"]["launches"][k] for r in ranks)
                for k in K.LAUNCHES}
    out = {}
    for name, (setup, w, h) in setups.items():
        legs = [r[name] for r in ranks]
        launches["B1"] += sum(leg["b1_launches"] for leg in legs)
        # the JAX test's balance gate holds for the sphere field; the
        # bench view puts most triangles in one band (printed)
        got = PD.check_raster(legs, setup, w, h, kernel=True,
                              balanced=name == "spheres")
        band_h = h // n
        want = [int(band_cull_setup(setup, b * band_h, band_h).valid.sum())
                for b in range(n)]
        check(got["counts"] == want, f"parallel {name}: band counts "
              f"{got['counts']}, band_cull_setup's {want}")
        for leg in legs:
            add_case(results, "B1", dict(leg["case"],
                                         launches=leg["b1_launches"]))
        # the same view unsharded, the bands' yardstick (not counted)
        pk, st, hr, hs = RB.bin_triangles(setup, w, h)[:4]
        whole = b1_case((st, hs, pk, hr, -(-w // RB.TILE_W),
                         -(-h // RB.TILE_H), RB.SPAN_W, RB.SPAN_H),
                        f"{name} {w}x{h} unsharded")
        add_case(results, "B1", whole)
        log(f"parallel {name} {w}x{h} over {n} bands: exact against the "
            f"unsharded B1 ({got['covered']} covered), counts {got['counts']}"
            f" of {got['total']} valid (the largest "
            f"{max(got['counts']) / got['total']:.3f} of it), stats "
            f"{ {k: v.tolist() for k, v in legs[0]['stats'].items()} }; "
            f"B1 a band ms {[round(leg['case']['ms'], 4) for leg in legs]}, "
            f"bound {[round(leg['case']['bound_ms'], 4) for leg in legs]}; "
            f"unsharded {whole['ms']:.4f} ms, bound {whole['bound_ms']:.4f}")
        out[name] = dict(got, unsharded_ms=whole["ms"], bands=[
            {k: leg["case"][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "max_abs_err")}
            for leg in legs])
    out["frame"] = parallel_frame_check([r["frame"] for r in ranks],
                                        f"{n} gloo ranks")
    t = time.monotonic()
    nccl = spawn_ranks(1, PD.dryrun_rank, {"frame": ("frame", dict(
        cfg=BENCH_CONFIG, width=WIDTH, height=HEIGHT, warmup=WARMUP,
        frames=PARALLEL_FRAMES, bench_scene=True))},
        backend="nccl", device="cuda")
    log(f"parallel: 1 nccl rank took {time.monotonic() - t:.1f} s")
    out["nccl"] = parallel_frame_check([nccl[0]["frame"]], "1 nccl rank")
    return launches, nccl[0]["frame"]["launches"], out


def sync_calls(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn") -> (its result,
    the synchronizing CUDA calls it made)."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum(1 for w in caught
                    if "synchronizing CUDA operation" in str(w.message))


SPAN_PREFIXES = ("pass:", "frame:", "decals")


def idle_by_span(events) -> dict:
    """The card's idle gaps over a trace (between its kernels, copies and
    sets), each put down to the innermost span the host was in at its
    middle -> {span name: idle s}."""
    from torch.autograd import DeviceType
    device = sorted((ev.time_range.start, ev.time_range.end)
                    for ev in events if ev.device_type == DeviceType.CUDA
                    and not ev.name.startswith(SPAN_PREFIXES + ("bench:",)))
    spans = [(ev.time_range.start, ev.time_range.end, ev.name)
             for ev in events if ev.device_type == DeviceType.CPU
             and ev.name.startswith(SPAN_PREFIXES)]
    out: dict = {}
    end = device[0][1]
    for a, b in device[1:]:
        if a > end:
            mid = 0.5 * (a + end)
            inner = [(s1 - s0, n) for s0, s1, n in spans if s0 <= mid <= s1]
            label = min(inner)[1] if inner else "outside the frame's spans"
            out[label] = out.get(label, 0.0) + (a - end) / 1e6
        end = max(end, b)
    return out


def span_off_us() -> float:
    """Microseconds an empty span costs with tracing off."""
    from granite_tpu_torch.utils.timeline_trace import span
    t = time.perf_counter()
    for _ in range(SPAN_OFF_CALLS):
        with span("off"):
            pass
    return 1e6 * (time.perf_counter() - t) / SPAN_OFF_CALLS


def spans_cell(name: str) -> dict:
    """The spans phase on one cell (see the module's docstring, 5)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from granite_tpu_torch.utils.timeline_trace import FrameRecorder
    width, height, traced = SPAN_CELLS[name]
    cfg = MAIN_PATHS[name][0]
    app = forward_pcf_app(cfg) if name == "forward_pcf" \
        else make_app(cfg, True, "cuda")
    app.swapchain_updated(width, height)
    state = {"i": 0}

    def render():
        i = state["i"]
        a = i * ORBIT
        app.camera.look_at(np.array([SPAN_ORBIT_RADIUS * np.cos(a),
                                     SPAN_EYE_HEIGHT,
                                     SPAN_ORBIT_RADIUS * np.sin(a)]),
                           SPAN_LOOK)
        t = time.perf_counter()
        out = app.render_frame(FRAME_TIME, (i + 1) * FRAME_TIME)
        return out, time.perf_counter() - t

    def finish(out):
        app.hub.frame().track(out)
        app.hub.next_frame_context()
        app.post_frame()
        state["i"] += 1

    def frames(n):
        calls = []
        for _ in range(n):
            out, dt = render()
            finish(out)
            calls.append(1e3 * dt)
        return calls

    frames(8)
    torch.cuda.synchronize()
    # the recorder on every other frame, so that both halves see the same
    # drift of the host's speed
    rec = FrameRecorder(app.hub)
    off, on = [], []
    for k in range(2 * SPAN_FRAMES):
        if k % 2:
            with rec:
                on += frames(1)
        else:
            off += frames(1)
    per = rec.frames()
    stages = sorted({k for f in per for k in f["total_ms"]})
    total = {k: sum(f["total_ms"].get(k, 0.0) for f in per) / len(per)
             for k in stages}
    self_ms = {k: sum(f["self_ms"].get(k, 0.0) for f in per) / len(per)
               for k in stages}
    counters = {k: sum(f["counters"].get(k, 0) for f in per) / len(per)
                for k in ("readbacks", "uploads", "uploads_staged",
                          "upload_bytes")}
    off_ms = sum(off) / len(off)
    on_cost = total["frame:render"] / off_ms - 1.0
    log(f"spans {name}: render_frame {off_ms:.3f} ms off, "
        f"{sum(on) / len(on):.3f} ms with the recorder, frame:render "
        f"{total['frame:render']:.3f} ms ({100 * on_cost:+.2f}%); "
        f"counters a frame {counters}")
    check(abs(on_cost) <= SPAN_ON_COST_GATE,
          f"spans {name}: frame:render {total['frame:render']:.3f} ms vs "
          f"render_frame {off_ms:.3f} ms with no recorder")
    check(all(k.startswith(SPAN_PREFIXES) for k in stages),
          f"spans {name}: a span outside pass:*, frame:*, decals: {stages}")

    # A traced frame's copies on the card against its counters, taken
    # again (up to TRACE_ATTEMPTS frames) where the trace lost a copy.
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with FrameRecorder(app.hub) as rec:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out, _dt = render()
                torch.cuda.synchronize()
            finish(out)
        c = rec.frames()[0]["counters"]
        events = prof.events()
        card = [ev.name for ev in events
                if ev.device_type == DeviceType.CUDA]
        copies = {"h2d": sum("Memcpy HtoD" in n for n in card),
                  "d2h": sum("Memcpy DtoH" in n for n in card),
                  "dtod": sum("Memcpy DtoD" in n for n in card),
                  "memcpy_calls": sum(ev.name == "cudaMemcpyAsync"
                                      for ev in events),
                  "uploads": c.get("uploads", 0),
                  "readbacks": c.get("readbacks", 0),
                  "attempt": attempt}
        log(f"spans {name}: a traced frame's copies {copies}")
        if copies["h2d"] == copies["uploads"] \
                and copies["d2h"] == copies["readbacks"]:
            break
    # Every copy is a cudaMemcpyAsync call on the host's timeline: the
    # uploads, the readbacks and the card's own DtoD copies.  The card's
    # records can lose a small copy (3 of the 2160p frame's 33 HtoD in
    # every attempt of some runs), so its HtoD ops are held to at most
    # the uploads, and equal where one attempt kept them all.
    check(copies["memcpy_calls"] == copies["uploads"]
          + copies["readbacks"] + copies["dtod"]
          and copies["h2d"] <= copies["uploads"]
          and copies["d2h"] == copies["readbacks"],
          f"spans {name}: copies on the card vs counted: {copies}")
    check(not any(n.startswith("frame:") for n in card),
          f"spans {name}: a frame:* span on the card's timeline")

    with FrameRecorder(app.hub) as rec:
        (out, _dt), n_sync = sync_calls(render)
        finish(out)
    c = rec.frames()[0]["counters"]
    sync = {"sync_calls": n_sync, "readbacks": c.get("readbacks", 0),
            "uploads": c.get("uploads", 0),
            "uploads_staged": c.get("uploads_staged", 0)}
    log(f"spans {name}: sync debug {sync}")
    check(n_sync == sync["readbacks"] + sync["uploads"]
          - sync["uploads_staged"],
          f"spans {name}: {n_sync} synchronizing calls, counted {sync}")
    check(sync["uploads_staged"] == sync["uploads"],
          f"spans {name}: an upload of the frame path not staged: {sync}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        frames(traced)
        torch.cuda.synchronize()
    events = prof.events()
    idle = idle_by_span(events)
    dev_ms: dict = {}
    for ev in events:
        if ev.device_type == DeviceType.CPU and ev.name.startswith("pass:"):
            dev_ms[ev.name] = dev_ms.get(ev.name, 0.0) \
                + ev.device_time_total / 1e3 / traced
    idle_s = sum(idle.values())
    split_s = sum(v for k, v in idle.items() if "/" in k)
    log(f"spans {name}: {idle_s:.4f} s idle over {traced} traced frames, "
        f"{100 * split_s / idle_s:.1f}% under a stage; by span "
        + json.dumps(sorted(idle.items(), key=lambda x: -x[1])[:12]))
    del app
    torch.cuda.empty_cache()
    return {"render_frame_ms_off": off_ms,
            "render_frame_ms_recorder": sum(on) / len(on),
            "recorder_on_cost": on_cost, "host_ms_total": total,
            "host_ms_self": self_ms, "counters_a_frame": counters,
            "sync_debug": sync, "traced_frame_copies": copies,
            "idle_s_by_span": idle, "traced_frames": traced,
            "device_ms_by_range": dev_ms}


def upload_us() -> dict:
    """Host us an upload costs, the card idle, by route and size: the
    blocking copy from pageable memory, upload() through the ring's
    pinned arena (the ring moved between batches of UPLOAD_BATCH, off the
    clock), and a pinned block of PyTorch's caching host allocator a copy
    (which records an event when the block is freed).  The routes take
    turns, in reversed order every other round of UPLOAD_ROUNDS; the
    median round of each."""
    import numpy as np
    import torch
    from granite_tpu_torch.core.device import Device
    from granite_tpu_torch.utils.timeline_trace import upload
    dev = torch.device("cuda", torch.cuda.current_device())
    hub = Device(dev)
    routes = {
        "blocking": lambda a: torch.as_tensor(a, device=dev),
        "arena": lambda a: upload(a, device=dev),
        "caching_host": lambda a: torch.from_numpy(a).pin_memory().to(
            dev, non_blocking=True)}
    rounds: dict = {}
    for r in range(UPLOAD_ROUNDS):
        for name, fn in (list(routes.items())[::-1 if r % 2 else 1]):
            for n in UPLOAD_SIZES:
                a = np.arange(n, dtype=np.float32)
                keep, t_ns = [], 0
                for b in range(-1, UPLOAD_CALLS // UPLOAD_BATCH):
                    torch.cuda.synchronize()
                    t = time.perf_counter_ns()
                    for _ in range(UPLOAD_BATCH):
                        keep.append(fn(a))
                    if b >= 0:          # batch -1 warms the route up
                        t_ns += time.perf_counter_ns() - t
                    hub.next_frame_context()
                    keep.clear()
                rounds.setdefault(f"{name}.{4 * n}B", []).append(
                    t_ns / 1e3 / UPLOAD_CALLS)
    hub.wait_idle()
    return {k: sorted(v)[len(v) // 2] for k, v in rounds.items()}


def spans_phase() -> dict:
    """The spans phase: each cell, then the off cost of a span and the
    host cost of an upload by route."""
    out = {name: spans_cell(name) for name in SPAN_CELLS}
    out["span_off_us"] = span_off_us()
    log(f"spans: an empty span costs {out['span_off_us']:.3f} us off")
    check(out["span_off_us"] <= SPAN_OFF_US_GATE,
          f"an empty span costs {out['span_off_us']:.3f} us off")
    out["upload_us"] = upload_us()
    log(f"spans: host us an upload, by route: {out['upload_us']}")
    return out


def cross_device() -> None:
    import numpy as np
    import torch
    from golden_utils import CONFIGS, psnr     # numpy only, no jax
    from granite_tpu_torch.app.bench_scene import build_default_test_scene
    from granite_tpu_torch.scene_export import export_gltf
    files = tempfile.TemporaryDirectory()
    write_animated_scene(files.name, build_default_test_scene(),
                         [(2.5, 1.2, 2.5)], (-2.5, 0.1, 2.5),
                         (7.0, 5.5, 9.0), (0.0, 0.8, 0.0))
    export_gltf(build_default_test_scene(),
                os.path.join(files.name, "test.gltf"))
    for name, (golden, decal_node, scene, knobs, camera) in \
            CROSS_DEVICE.items():
        cfg = {**CONFIGS[golden], **knobs, "materialTileSampler": "true"}
        imgs = {}
        for device in ("cuda", "cpu"):
            app = make_app(cfg, False, device,
                           scene=scene and os.path.join(files.name, scene),
                           camera_index=0 if scene == "anim.scene" else -1)
            if camera is not None:
                app.camera.look_at(*(np.asarray(c, np.float32)
                                     for c in camera))
            if decal_node:
                # tests/test_decals.py's box over the test scene's floor
                node = app.scene.create_node(translation=(0, 0, 0),
                                             scale=(6, 6, 6))
                app.scene.create_volumetric_decal(node, 0)
                app.scene.update_transform_tree()
            app.swapchain_updated(128, 72)
            out = None
            for i in range(2):
                out = app.render_frame(FRAME_TIME, i * FRAME_TIME)
            imgs[device] = out.cpu().numpy()
        torch.cuda.synchronize()
        p = psnr(imgs["cuda"], imgs["cpu"])
        log(f"cross-device {name} 128x72: cuda vs cpu luma PSNR {p:.2f} dB")
        check(p >= PSNR_GATE_DB,
              f"cross-device {name} PSNR {p:.2f} < {PSNR_GATE_DB}")
    files.cleanup()


def main() -> int:
    import torch
    # golden_utils and gltf_fixtures (numpy and json only) live in tests/
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    t_start = time.monotonic()
    card, attrs = probe()
    if sys.argv[1:] == ["--spans"]:
        print(json.dumps({"spans": spans_phase()}))
        print(card)
        return 0
    t = time.monotonic()
    probe_result, probe_launches = compile_probe_path()
    log(f"compile probe took {time.monotonic() - t:.1f} s")
    results: dict = {}
    kernel_phases(results)
    slice_kernel_phases(results)
    floor_ms = launch_floor()
    log(f"phases 1-2 took {time.monotonic() - t_start:.1f} s")
    by_path = {"compile_probe": probe_launches}
    kept: dict = {}
    for name in MAIN_PATHS:
        t = time.monotonic()
        by_path[name] = main_path(name, results, kept)
        log(f"phase 3 path {name} took {time.monotonic() - t:.1f} s")
    t = time.monotonic()
    video = tempfile.TemporaryDirectory()
    seq = os.path.join(video.name, "frames")
    os.makedirs(seq)
    write_video_frames(seq)
    log(f"video frames written in {time.monotonic() - t:.1f} s")
    by_path["video_player"] = video_player_path(seq)
    log(f"phase 3 path video_player took {time.monotonic() - t:.1f} s")
    t = time.monotonic()
    tools_dir = tempfile.TemporaryDirectory()
    by_path["tools"], tools = tools_path(tools_dir.name)
    tools_dir.cleanup()
    log(f"phase tools took {time.monotonic() - t:.1f} s")
    t = time.monotonic()
    by_path["host_subsystems"], host = host_subsystems(
        kept.pop("deferred"))
    log(f"phase host_subsystems took {time.monotonic() - t:.1f} s")
    t = time.monotonic()
    by_path["parallel"], by_path["parallel_nccl"], parallel = \
        parallel_phase(results)
    log(f"phase parallel took {time.monotonic() - t:.1f} s")
    t = time.monotonic()
    spans = spans_phase()
    log(f"phase spans took {time.monotonic() - t:.1f} s")
    t = time.monotonic()
    cross_device()
    streaming_cross_device()
    triangle = triangle_demo()
    video_cross_device(seq)
    video.cleanup()
    log(f"phase 4 took {time.monotonic() - t:.1f} s; the run "
        f"{time.monotonic() - t_start:.1f} s")
    kernels = []
    for k, (src, rep, _entries) in KERNELS.items():
        r = dict(results[k])
        kernels.append({
            "name": k, "route": "cuda", "source": src, "replaces": rep,
            # launches: the sum over the main paths (each counted from 0)
            "launches": sum(n[k] for n in by_path.values()),
            "max_abs_err": r.pop("max_abs_err"), "ms": r.pop("ms"),
            "plain_ms": r.pop("plain_ms"), "bound_ms": r.pop("bound_ms"),
            "bound_by": r.pop("bound_by"),
            "library_ms": r.pop("library_ms", None),
            "launches_by_path": {p: n[k] for p, n in by_path.items()},
            "attributes": attrs[k], **r})
    print(json.dumps({
        "timing": "ms: device time, CUDA graph of N wrapper calls replayed "
                  "between CUDA events; plain_ms: CUDA events around N "
                  "calls; library_ms: as ms; launch_floor_ms: as ms, "
                  "x.add_(1.0) on one float32",
        "launch_floor_ms": floor_ms,
        "compile_probe": probe_result, "triangle_demo": triangle,
        "tools": tools, "host_subsystems": host, "parallel": parallel,
        "spans": spans,
        "kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
