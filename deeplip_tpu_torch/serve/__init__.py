"""Online serving: speaker verification and identification from a trained
model, audio-only (:class:`SpeakerVerifier`, with :class:`MicroBatcher` in
front of it under concurrent load) or audio-visual
(:class:`AVSpeakerVerifier`)."""

from deeplip_tpu_torch.serve.av import AVSpeakerVerifier
from deeplip_tpu_torch.serve.microbatch import MicroBatcher
from deeplip_tpu_torch.serve.verifier import ProfileVerifier, SpeakerVerifier, VerifyResult

__all__ = ["AVSpeakerVerifier", "MicroBatcher", "ProfileVerifier", "SpeakerVerifier",
           "VerifyResult"]
