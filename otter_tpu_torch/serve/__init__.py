"""The serving stack (counterpart of `otter_tpu/serve/`): the controller,
the web UI, the conversation templates, the moderation gate and the two
small HTTP tools are copies of the JAX package's, which use no JAX; the
worker and the CLI run the port's engines."""

from otter_tpu_torch.serve.controller import Controller, DispatchMethod
from otter_tpu_torch.serve.conversation import (Conversation, conv_templates,
                                                default_conversation)
from otter_tpu_torch.serve.worker import ModelWorker, decode_images_to_vision_x
