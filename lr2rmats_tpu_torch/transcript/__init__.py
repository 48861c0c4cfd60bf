from .model import Transcripts, UpdateGtfParams, DEFAULTS
