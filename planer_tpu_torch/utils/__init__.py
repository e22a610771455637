"""Host-side utilities of the port: image resampling and filters
(``image``) and tiled inference of large images (``tile``)."""
from .image import resize, mapcoord, uniform_filter, gaussian_filter
from .tile import tile

__all__ = ["resize", "mapcoord", "uniform_filter", "gaussian_filter", "tile"]
