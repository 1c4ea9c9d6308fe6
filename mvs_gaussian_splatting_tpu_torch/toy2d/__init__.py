from .splat2d import (Splat2DParams, fit_image, init_splats,  # noqa: F401
                      params_from_numpy, render_splats2d)
