"""OpenAI-compatible chat client for LLM judges (stdlib HTTP, no openai sdk;
`grasp_any_region_tpu/evaluation/judges/client.py`).

Works against Azure OpenAI (AZURE_OPENAI_ENDPOINT/KEY, like the reference's
judges, GAR-Bench/eval_simple.py:27-31), any OpenAI-compatible server
(OPENAI_BASE_URL/OPENAI_API_KEY), or a local vLLM-style judge
(DLC-Bench/serve_judge.sh). Retries with backoff (the reference retries
forever, Ferret-Bench/eval_gpt.py:27-52 — here bounded), plus a call-budget
guard (DLC-Bench/eval_gpt_with_image.py:62-66). The judges run on a host
that reaches the judge service; images go out as PNG through
`data/png.write_png` (no PIL).
"""

from __future__ import annotations

import base64
import json
import os
import time
import urllib.request
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ...data.png import write_png


@dataclass
class JudgeConfig:
    model: str = "gpt-4o-2024-11-20"
    endpoint: Optional[str] = None  # full chat-completions URL
    api_key: Optional[str] = None
    azure_api_version: str = "2024-03-01-preview"
    max_tokens: int = 1000
    temperature: float = 0.0
    max_retries: int = 8
    call_budget: Optional[int] = None  # hard cap on API calls

    def resolve(self) -> "JudgeConfig":
        ep = self.endpoint
        key = self.api_key
        if ep is None:
            azure = os.getenv("AZURE_OPENAI_ENDPOINT")
            base = os.getenv("OPENAI_BASE_URL")
            if azure:
                ep = (
                    f"{azure.rstrip('/')}/openai/deployments/{self.model}"
                    f"/chat/completions?api-version={self.azure_api_version}"
                )
                key = key or os.getenv("AZURE_OPENAI_KEY")
            elif base:
                ep = f"{base.rstrip('/')}/chat/completions"
                key = key or os.getenv("OPENAI_API_KEY", "none")
        if ep is None:
            raise RuntimeError(
                "no judge endpoint: set AZURE_OPENAI_ENDPOINT(+KEY) or "
                "OPENAI_BASE_URL(+OPENAI_API_KEY), or pass endpoint="
            )
        return JudgeConfig(**{**self.__dict__, "endpoint": ep, "api_key": key})


class JudgeClient:
    def __init__(self, cfg: JudgeConfig):
        self.cfg = cfg.resolve()
        self.calls = 0

    def chat(self, messages: List[dict]) -> str:
        cfg = self.cfg
        if cfg.call_budget is not None and self.calls >= cfg.call_budget:
            raise RuntimeError(f"judge call budget {cfg.call_budget} exhausted")
        payload = json.dumps(
            {
                "model": cfg.model,
                "messages": messages,
                "max_tokens": cfg.max_tokens,
                "temperature": cfg.temperature,
                "top_p": 1,
            }
        ).encode()
        headers = {"Content-Type": "application/json"}
        if cfg.api_key:
            headers["api-key"] = cfg.api_key
            headers["Authorization"] = f"Bearer {cfg.api_key}"
        last = None
        for attempt in range(cfg.max_retries):
            try:
                req = urllib.request.Request(cfg.endpoint, payload, headers)
                with urllib.request.urlopen(req, timeout=120) as resp:
                    out = json.loads(resp.read())
                self.calls += 1
                return out["choices"][0]["message"]["content"]
            except Exception as e:  # noqa: BLE001
                last = e
                time.sleep(min(2 ** attempt, 30))
        raise RuntimeError(f"judge request failed after retries: {last}")


def image_content(np_image) -> dict:
    """numpy (H, W[, 3]) -> OpenAI image_url content part (PNG base64, under
    the data-URL type JAX's client sends)."""
    arr = np.asarray(np_image)
    if arr.dtype != "uint8":
        arr = np.clip(arr, 0, 255).astype("uint8")
    b64 = base64.b64encode(write_png(np.ascontiguousarray(arr))).decode()
    return {"type": "image_url", "image_url": {"url": f"data:image/jpeg;base64,{b64}"}}
