"""The web UI: the counterpart of ``conzic_tpu.api.app``.

    python -m conzic_torch.api.app [--ui auto|gradio|fallback] [--port 7860]
        [--lm_model DIR --match_model DIR | --random_models [tiny]]
        [--device cuda|cpu]

The reference's Gradio Blocks UI, widget for widget: run-type radio,
control-type radio with the reference's visibility rules, the
sentence-length, iteration and sample sliders, alpha, beta and gamma, and
two output boxes (final and best captions) joined by :func:`format_output`.
gradio is imported only by :func:`build_ui`; without it (``--ui auto``)
the stdlib server of ``api.fallback_ui`` serves the same widgets.

Divergence kept from the reference package: the reference's app reloads
both models on every Submit; here they load once and every request reuses
them. The captioner runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

from conzic_torch.config import (
    DEFAULT_POS_TEMPLATE,
    ConzicConfig,
    config_from_args,
)
from conzic_torch.engine.sampler import (
    control_generate_caption,
    generate_caption,
)
from conzic_torch.runtime.logging import null_logger
from conzic_torch.runtime.seeding import set_seed


def format_output(sample_num, final_caption, best_caption):
    """Join the first 1..N samples with newlines (the reference's
    ``utils.format_output``)."""
    n = max(1, min(int(sample_num), len(final_caption)))
    return "\n".join(final_caption[:n]), "\n".join(best_caption[:n])


def make_demo_fn(captioner, cfg: ConzicConfig):
    """The Submit callback: ``samples_num`` generations over one image,
    seeded from ``cfg.seed`` on every call; returns the (final, best)
    strings."""
    logger = null_logger()

    def demo(run_type, control_type, sentiment_type, order, prompt,
             sentence_len, num_iterations, samples_num, alpha, beta, gamma,
             image):
        rng = set_seed(cfg.seed)
        finals, bests = [], []
        image_embeds = captioner.encode_images([image])
        for _ in range(int(samples_num)):
            kw = dict(prompt=prompt, batch_size=1, max_len=int(sentence_len),
                      top_k=cfg.candidate_k, temperature=cfg.lm_temperature,
                      max_iter=int(num_iterations), alpha=alpha, beta=beta,
                      generate_order=order, rng=rng)
            if run_type == "caption":
                texts, _ = generate_caption(["app"], captioner, image_embeds,
                                            logger, **kw)
            else:
                texts, _ = control_generate_caption(
                    ["app"], captioner, image_embeds, logger, gamma=gamma,
                    ctl_type=control_type, style_type=sentiment_type,
                    pos_type=DEFAULT_POS_TEMPLATE, **kw)
            finals.append(texts[-2][0])
            bests.append(texts[-1][0])
        return format_output(samples_num, finals, bests)

    return demo


def control_widgets_visible(run_type: str) -> bool:
    """The control-type widgets show for controllable runs only (the
    reference's RunTypeChange)."""
    return run_type == "controllable"


def sentiment_widget_visible(control_type: str) -> bool:
    """The sentiment radio shows for sentiment control only (the
    reference's ControlTypeChange)."""
    return control_type == "sentiment"


def reset_values():
    """The widgets' values after Reset, as the reference sets them."""
    d = ConzicConfig()
    return ("caption", "sentiment", "positive", "shuffle",
            "Image of a", 10, 10, 2, d.alpha, d.beta, d.gamma)


def build_ui(captioner, cfg: ConzicConfig):
    """The Gradio Blocks app (needs ``gradio``)."""
    import gradio as gr

    demo_fn = make_demo_fn(captioner, cfg)
    with gr.Blocks() as ui:
        gr.Markdown("# ConZIC: Controllable Zero-shot Image Captioning")
        with gr.Row():
            with gr.Column():
                run_type = gr.Radio(["caption", "controllable"],
                                    value="caption", label="Run Type")
                control_type = gr.Radio(["sentiment", "pos"],
                                        value="sentiment",
                                        label="Control Type", visible=False)
                sentiment_type = gr.Radio(["positive", "negative"],
                                          value="positive",
                                          label="Sentiment", visible=False)
                order = gr.Radio(["sequential", "shuffle", "span", "random"],
                                 value="shuffle", label="Generation Order")
                prompt = gr.Textbox(value="Image of a", label="Prompt")
                sentence_len = gr.Slider(5, 15, value=10, step=1,
                                         label="Sentence Length")
                num_iterations = gr.Slider(1, 15, value=10, step=1,
                                           label="Num Iterations")
                samples_num = gr.Slider(1, 5, value=2, step=1,
                                        label="Samples")
                alpha = gr.Slider(0, 1, value=cfg.alpha, step=0.01,
                                  label="Alpha", info="Weight for fluency")
                beta = gr.Slider(1, 5, value=cfg.beta, step=0.5,
                                 label="Beta",
                                 info="Weight for image-matching degree")
                gamma = gr.Slider(1, 10, value=cfg.gamma, step=0.5,
                                  label="Gamma",
                                  info="weight for controllable degree")
                image = gr.Image(type="pil", label="Upload Picture")
                with gr.Row():
                    submit = gr.Button("Submit")
                    reset = gr.Button("Reset")
            with gr.Column():
                final_out = gr.Textbox(label="Final Caption", lines=5,
                                       placeholder="Final Caption")
                best_out = gr.Textbox(label="Best Caption", lines=5,
                                      placeholder="Best Caption")

        def on_run_type(rt):
            vis = control_widgets_visible(rt)
            return gr.update(visible=vis), gr.update(visible=vis)

        run_type.change(on_run_type, [run_type],
                        [control_type, sentiment_type])

        def on_control_type(ct):
            return gr.update(visible=sentiment_widget_visible(ct))

        control_type.change(on_control_type, [control_type],
                            [sentiment_type])
        widgets = [run_type, control_type, sentiment_type, order, prompt,
                   sentence_len, num_iterations, samples_num, alpha, beta,
                   gamma]
        submit.click(demo_fn, widgets + [image], [final_out, best_out])
        reset.click(reset_values, [], widgets)
    return ui


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lm_model", default=ConzicConfig.lm_model)
    p.add_argument("--match_model", default=ConzicConfig.match_model)
    p.add_argument("--random_models", nargs="?", const="full",
                   choices=["full", "tiny"], default=False)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda runs the hand-written kernels on the card and "
                        "raises without one; cpu runs their plain versions")
    p.add_argument("--ui", choices=["auto", "gradio", "fallback"],
                   default="auto",
                   help="auto: gradio when installed, else the stdlib "
                        "fallback server with the same widgets")
    args = p.parse_args(argv)

    use_gradio = args.ui in ("auto", "gradio")
    if use_gradio:
        try:
            import gradio  # noqa: F401
        except ImportError:
            if args.ui == "gradio":
                raise SystemExit(
                    "gradio is not installed; re-run with --ui fallback "
                    "(the same widgets on a stdlib server).")
            use_gradio = False

    from conzic_torch.api.demo import build_captioner

    cfg = config_from_args(args)
    captioner = build_captioner(cfg, random_models=args.random_models,
                                device=args.device)
    if use_gradio:
        build_ui(captioner, cfg).launch(server_port=args.port)
    else:
        from conzic_torch.api.fallback_ui import serve

        serve(captioner, cfg, port=args.port)


if __name__ == "__main__":
    main()
