"""``python -m psana_ray_tpu_torch.obs.top``: the live federated console
(:mod:`psana_ray_tpu_torch.obs.console`)."""

from psana_ray_tpu_torch.obs.console import main

if __name__ == "__main__":
    raise SystemExit(main())
