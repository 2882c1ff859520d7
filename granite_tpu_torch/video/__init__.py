"""Video subsystem (copy of granite_tpu/video/): encode sink
(app/video_sink.py) + pyro streaming
protocol (reference video/ffmpeg_{encode,decode}.cpp, pyro_protocol.h)."""
