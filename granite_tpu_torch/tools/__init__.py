"""Tools of the port, each a counterpart of the JAX package's tools/*.py
with its flags and output, run as python -m granite_tpu_torch.tools.<name>:
image_compare, gtx_cat, texture_viewer, image_packer, brdf_lut_generate,
obj_to_gltf, bitmap_to_mesh, gltf_repacker,
convert_equirect_to_environment, convert_cube_to_environment,
sweep_scene, aa_bench, quality_receipt, hw_verify and
compile_parallel_probe.  Those that render or compute in torch take
--device (default cuda)."""
