"""The benchmark harness of granite_tpu_torch (see benchmark/README.md).

A configuration (configs/<config>.json) names its reference and the maps
judged beside the frames.  The contract of a reference, all that the
harness and the per-layer readers use of it:

- "reference": "<module>:<class>", a module under benchmark/, imported
  with benchmark/ on the path ("plainref.frame:ReferenceFrame").
- KNOBS, on the class: {viewer knob: the values it models, None for any
  value}.  run.py refuses a configuration that sets a knob missing there,
  or another value, before it looks for the card (cell.reference_for,
  which constructs nothing).
- cls(info, viewer_cfg, width, height, lens, device, control=False):
  info the scene (gref dataclasses), lens {"fovy", "znear", "zfar"};
  control=True is the reference at the precision below the
  configuration's, the control that has to come out not correct.
- surface(position, rotation) -> the pose's float32 planes {"depth",
  "covered", "hdr"}, with "g-base", "g-normal", "g-pbr", "g-emissive"
  and "g-pos" where `deferred`, and each per-frame judged map under its
  limit's name.
- post(hdr) -> the (H, W, 4) uint8 backbuffer, advancing `history`;
  initial_history() -> the history before the lead-in.
- deferred: whether the G-buffer planes are judged.
- each set-up judged map as an attribute named by its limit (None: the
  reference has none, and the run is not correct).
- what the roofline reads (run.py, gbench/roofline.py): sa (plainref's
  SceneArrays), view(position, rotation) -> (view, view-projection,
  camera position), width, height, n_lights, k_shadow.

"judged_maps": {limit: source}, each source from the fixed table of
cell.py: "setup:static_shadow" (the viewer's cached static sun map),
"setup:cluster_atlas" (the clustered lights' depth atlas, (slices, S,
S)), "frame:<pool resource>" (that plane of the graph's pool, kept from
each judged frame).  judge.compare_depth_map judges each: a set-up map
once, a per-frame map at every judged frame, the worst counting.

A per-layer reader (metrics/<metric>.py) gets the run's readings with
run["ref"], the reference, and run["config"], the configuration.
"""
