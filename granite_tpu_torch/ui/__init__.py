from .flat_renderer import FlatRenderer, draw_text, font_bitmap
from .widgets import (
    ClickButton, HorizontalPacking, Image, Label, Slider, ToggleButton,
    UIManager, VerticalPacking, Widget, Window,
)
