"""Serving stack: the controller/worker HTTP protocol, the web chat and
OpenAI-compatible front-ends, client utilities, and the continuous-batching
engine (the names of ``microscopiq_tpu/serve/__init__.py``).
"""

from .cli import (chat_loop, get_worker, list_models, register_worker,
                  stream_generate, test_message)
from .controller import Controller, serve_controller
from .engine import BatchEngine, Request, engine_generate_stream_fn
from .openai_api import OpenAIGateway, serve_openai
from .web_server import WebServer, serve_web
from .worker import ModelWorker, serve_worker

__all__ = [
    "BatchEngine", "Request", "engine_generate_stream_fn",
    "Controller", "serve_controller", "ModelWorker", "serve_worker",
    "OpenAIGateway", "serve_openai", "WebServer", "serve_web",
    "chat_loop", "get_worker", "list_models", "register_worker",
    "stream_generate", "test_message",
]
