"""References that the harness's tests name in a configuration's
"reference" ("stub_reference:<class>"): plainref's ReferenceFrame with
one change each."""

from plainref.frame import ReferenceFrame


class ScaledReference(ReferenceFrame):
    """The lit HDR at 2 x plainref's + 1: every pixel of every judged
    frame off by half of 1 + |reference|."""

    def surface(self, position, rotation):
        out = super().surface(position, rotation)
        out["hdr"] = out["hdr"] * 2.0 + 1.0
        return out


class FrameSunReference(ReferenceFrame):
    """The sun map given with every frame, as a per-frame judged map."""

    def surface(self, position, rotation):
        out = super().surface(position, rotation)
        out["sun_depth"] = self.sun_depth
        return out
