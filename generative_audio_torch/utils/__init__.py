"""Device choice, weight conversion, config, logging, tracking, the run
report and training auxiliaries."""
from generative_audio_torch.utils.auxil import (  # noqa: F401
    EncapsulatedRandomState, LoopLoader, StatusMessages, Timer,
    run_and_profile, set_random_seed)
from generative_audio_torch.utils.tracking import (  # noqa: F401
    ArtifactRegistry, ExperimentTracker)
from generative_audio_torch.utils.report import (  # noqa: F401
    HTMLReport, imgs_to_grid)
