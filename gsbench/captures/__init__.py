"""The shapes of a synthetic capture, one module a configuration's
``capture``, found by name. A module gives ``cloud(cfg, gen, device)``
(the raw leaves of the N Gaussians), ``train_cameras(cfg, rng)`` (the
capture's camera centres and look targets, [K, 3] each) and
``orbit(cfg, poses)`` (a render path's (centre, target) pairs)."""
