"""glTF and camera export (copy of granite_tpu/scene_export: the glTF
writer and the recorded-camera JSON)."""

from .gltf_export import export_gltf
