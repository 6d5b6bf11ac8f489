"""Streamlit training-monitor protocol (a copy of
``jarvis_hybridnet_tpu/utils/st_monitor.py``).

The reference trainers drive a 5-widget list passed by the GUI
(jarvis/ui/gui/train_gui.py:56-60; jarvis/efficienttrack/
efficienttrack.py:249,288-293,360-373):

  [0] total progress bar (fraction of epochs)
  [1] per-epoch progress bar (fraction of steps)
  [2] epoch counter (markdown)
  [3] live loss line chart
  [4] live accuracy line chart

plus ``st.session_state`` result caching so the GUI can re-render after
the run. This helper drives whatever prefix of that protocol the caller
supplied (a bare [progress] list keeps working), keeping the trainers free
of streamlit imports: ``streamlit`` is imported only to cache the results,
and the cache is skipped where it is not installed.
"""

from __future__ import annotations


class StreamlitTrainingMonitor:
    def __init__(self, widgets, mode: str, acc_unit: str = "px"):
        self.widgets = widgets or []
        self.mode = mode
        self.acc_unit = acc_unit

    def _widget(self, idx):
        return self.widgets[idx] if len(self.widgets) > idx else None

    def start(self, num_epochs: int) -> None:
        w = self._widget(2)
        if w is not None:
            w.markdown(f"Epoch 1/{num_epochs}")

    def step(self, count: int, steps_per_epoch: int) -> None:
        w = self._widget(1)
        if w is not None:
            w.progress(float(count + 1) / float(max(1, steps_per_epoch)))

    def epoch(self, epoch: int, num_epochs: int, history: dict) -> None:
        w = self._widget(0)
        if w is not None:
            w.progress(float(epoch + 1) / float(num_epochs))
        w = self._widget(2)
        if w is not None:
            w.markdown(f"Epoch {epoch + 1}/{num_epochs}")
        w = self._widget(3)
        if w is not None:
            w.line_chart({
                "Train Loss": list(history["train_loss"]),
                "Val Loss": list(history["val_loss"]),
            })
        w = self._widget(4)
        if w is not None:
            u = self.acc_unit
            w.line_chart({
                f"Train Accuracy [{u}]": list(history["train_acc"]),
                f"Val Accuracy [{u}]": list(history["val_acc"]),
            })
        if len(self.widgets) > 2:
            self._cache_results(history)

    def _cache_results(self, history: dict) -> None:
        try:
            import streamlit as st
        except ImportError:  # pragma: no cover
            return
        try:
            st.session_state[self.mode + "/Train Loss"] = \
                list(history["train_loss"])
            st.session_state[self.mode + "/Train Accuracy"] = \
                list(history["train_acc"])
            st.session_state[self.mode + "/Val Loss"] = \
                list(history["val_loss"])
            st.session_state[self.mode + "/Val Accuracy"] = \
                list(history["val_acc"])
            st.session_state["results_available"] = True
        except Exception:
            # outside a streamlit script run session_state raises; the
            # widget protocol itself (duck-typed) still worked
            pass
