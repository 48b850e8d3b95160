"""DEM-source helpers: the projection math (:mod:`.geodesy`) and the DEM
fetchers (:mod:`.catalog`, :mod:`.hrdem_stac`), host-only copies of the JAX
package's."""

from floodsr_tpu_torch.dem_sources.catalog import fetch_dem
from floodsr_tpu_torch.dem_sources.base import DemFetchResult

__all__ = ["fetch_dem", "DemFetchResult"]
