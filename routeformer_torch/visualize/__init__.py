"""Visualization (counterpart of ``routeformer_tpu/visualize/``): gaze
heatmap overlays, GPS trajectories over an offline basemap, and figures as
images.

matplotlib is imported only by the functions that draw: the package and
the gaze overlay work without it, and a drawing call on a host without it
raises ``ImportError`` naming the file that needs it.
"""

from routeformer_torch.visualize.gaze import overlay_heatmap_on_frame
from routeformer_torch.visualize.plot import plot_gps_data_on_map, render_figure_to_image

__all__ = ["plot_gps_data_on_map", "render_figure_to_image", "overlay_heatmap_on_frame"]
