"""Headless visualisation: frame overlays (FrameDrawer), map views
(MapDrawer) and a viewer that writes them as PNG files, in numpy, from
host copies of the tracker's tensors."""

from eao_slam_torch.viz.frame_drawer import draw_frame
from eao_slam_torch.viz.map_drawer import MapRenderOptions, render_map
from eao_slam_torch.viz.raster import save_png
from eao_slam_torch.viz.viewer import HeadlessViewer, ViewerOptions

__all__ = ["draw_frame", "render_map", "MapRenderOptions", "save_png", "HeadlessViewer",
           "ViewerOptions"]
