"""The campaign engine of the port — the counterpart of
``corrosion_tpu/campaign``:

- `spec` — `CampaignSpec`, the content-hashed experiment (scenario ×
  topology × fault events × grid × seeds) and the nine builtin specs;
- `report` — the per-seed bands, the result digest and `compare`;
- `ensemble` — seed ensembles on the packed round: K lanes of one
  configuration as one lane-batched program (`run_seed_ensemble`);
- `engine` — `run_campaign`: grid cells through the ensemble into a
  resumable JSON artifact whose ``result_digest`` equals JAX's.

The spec and report layers load without a card; the ensemble and the
engine take ``device`` (default ``"cuda"``).
"""

from .spec import (  # noqa: F401
    BUILTIN_SPECS,
    CampaignSpec,
    builtin_spec,
    load_spec,
    save_spec,
)
