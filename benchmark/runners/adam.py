"""Adam in a step cell: the state the engine starts a scale with, the
runner it drives, and the first gradient as Adam holds it after one step
(mu / (1 - beta1)), in float64."""


def init(step, image):
    return step.adam_init(image)


def runner(step, cfg):
    return step.make_adam_runner(cfg)


def first_grad(cfg, opt):
    return opt.mu.double() / (1.0 - cfg.beta1)
