"""Pipeline drivers: the Decoder (MP3->WAV) and Encoder (WAV->MP3) models that
wire the host bitstream plane to the device numeric plane."""

from mp3stego_tpu.models.decoder import Decoder  # noqa: F401
from mp3stego_tpu.models.encoder import Encoder  # noqa: F401
