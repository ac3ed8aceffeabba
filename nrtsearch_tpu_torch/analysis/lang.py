"""Copy of ``nrtsearch_tpu/analysis/lang.py``, kept whole: the port imports
nothing of the JAX package, not even its backend-free modules.

Language analysis data: stopword lists, light stemmers, elision articles.

The reference exposes Lucene's predefined per-language analyzers by name
("en.English", "fr.French", ... — AnalyzerCreator.java resolves
org.apache.lucene.analysis.<pkg>.<Name>Analyzer). The chains here mirror that
surface (tokenize -> lowercase -> [elision] -> stopwords -> stemmer) with
clean-room *light* suffix-stripping stemmers in the style of Savoy's light
stemmers — deliberately simpler than Snowball, favoring precision (they only
strip high-confidence plural/inflection suffixes). Token-level outputs are
therefore NOT bit-identical to Lucene's snowball chains; the analyzer names,
chain structure, and stopword semantics match the reference surface.

Stopword lists are the high-frequency function words of each language
(written from common knowledge, not copied from any single source).
"""

from __future__ import annotations

STOPWORDS: dict[str, frozenset] = {
    "en": frozenset(
        """a an and are as at be but by for if in into is it no not of on or
        such that the their then there these they this to was will with""".split()
    ),
    "fr": frozenset(
        """au aux avec ce ces dans de des du elle en et eux il ils je la le les
        leur lui ma mais me meme mes moi mon ne nos notre nous on ou par pas
        pour qu que qui sa se ses son sur ta te tes toi ton tu un une vos
        votre vous c d j l m n s t y este etre avoir fait plus""".split()
    ),
    "de": frozenset(
        """aber alle als also am an auch auf aus bei bin bis bist da damit das
        dass dein der den des dem die dies doch dort du durch ein eine einem
        einen einer eines er es euer fur hatte haben hat ich ihr im in ist ja
        jede kann kein mein mit nach nicht noch nun nur ob oder sehr sein sich
        sie sind so um und uns unter vom von vor war was weiter wenn wer wie
        wir wird zu zum zur""".split()
    ),
    "es": frozenset(
        """a al algo como con de del desde donde el ella ellas ellos en entre
        era eres es esta estas este esto estos fue ha han hasta hay la las le
        les lo los mas me mi mis muy no nos nosotros o os otra otros para pero
        poco por porque que quien se ser si sin sobre son su sus te tiene todo
        tu tus un una uno unos y ya yo""".split()
    ),
    "it": frozenset(
        """a ad agli ai al alla alle allo anche che chi ci come con contro da
        dal dalla dei del della delle dello di dove e ed era essere fra gli ha i
        hanno il in io la le lei lo loro lui ma mi mia mio ne nei nel nella
        noi non nostro o per piu quale quando questa questo se sei si sia
        sono su sua sue sui sul sulla suo tra tu tua tuo un una uno voi""".split()
    ),
    "pt": frozenset(
        """a ao aos as com como da das de dela dele dem do dos e ela elas ele
        eles em entre era essa esse esta este eu foi for ha isso isto ja la
        lhe mais mas me mesmo meu minha muito na nao nas nem no nos nossa
        nosso o os ou para pela pelo por qual quando que quem se sem ser seu
        sua tambem te tem ter teu tua um uma voce vos""".split()
    ),
    "nl": frozenset(
        """aan al alles als altijd andere ben bij daar dan dat de der deze die
        dit doch doen door dus een en er ge geen geweest haar had heb hebben
        heeft hem het hier hij hoe hun iemand iets ik in is ja je kan kon kunnen
        maar me meer men met mij mijn moet na naar niet niets nog nu of om omdat
        onder ons ook op over reeds te tegen toch toen tot u uit uw van veel
        voor want waren was wat werd wezen wie wil worden wordt zal ze zelf
        zich zij zijn zo zonder zou""".split()
    ),
    "ru": frozenset(
        """и в во не что он на я с со как а то все она так его но да ты к у же
        вы за бы по ее мне было вот от меня еще нет о из ему теперь когда даже
        ну ли если уже или ни быть был него до вас нибудь вам сказал себя ей
        может они есть надо при мы этот чтобы без будет человек чего раз тоже
        себе под жизнь будет этом один почти мой тем чтоб нее сейчас были куда
        зачем всех можно при об хотя их более всегда конечно всю между""".split()
    ),
    "sv": frozenset(
        """alla att av blev bli den denna der det detta du efter ej eller en
        er ett for fran ha hade han hans har hon hur i icke inte jag ju kan
        kunde man med mellan men mig min mot mycket ni nu nar och om oss pa sa
        sadan sig sin sitt skulle som till under upp ut utan vad var varfor
        vem vi vid vilken""".split()
    ),
    "da": frozenset(
        """af alle alt anden at blev blive bliver da de dem den denne der deres
        det dette dig din disse dog du efter eller en end er et for fra ham han
        hans har havde have hende hendes her hos hun hvad hvis hvor i ikke ind
        jeg jer jo kunne man mange med meget men mig min mine mit mod ned noget
        nogle nu og ogsa om op os over pa selv sig sin sine sit skal skulle
        som sadan thi til ud under var vi vil ville vor""".split()
    ),
    "no": frozenset(
        """alle at av begge da de den denne der det dette du eller en er et
        etter for fra ha hadde han hans har hennes her hun hva hvem hvis hvor
        i ikke inn jeg kan kunne man med meg mellom men mer min mot mye na nar
        og om opp oss over pa sa seg selv sin sitt skal skulle som til under
        ut var vi vil ville""".split()
    ),
    "fi": frozenset(
        """ei en et ette etta he hyvin ja jo joka jos kanssa keita kuin kun me
        mika mina mita mutta myos ne niin nyt ole oli olla olleet on ovat se
        sen siina sita te tai tama vaan vai vain voi""".split()
    ),
}

# elision: leading article + apostrophe dropped before analysis (Lucene
# ElisionFilter; French/Italian/Catalan chains)
ELISION_ARTICLES: dict[str, frozenset] = {
    "fr": frozenset("l m t qu n s j d c jusqu quoiqu lorsqu puisqu".split()),
    "it": frozenset(
        "c l all dall dell nell sull coll pell gl agl dagl degl negl sugl un m t s v d".split()
    ),
    "ca": frozenset("d l m n s t".split()),
}

_VOWELS = set("aeiouyàáâäéèêëíìîïóòôöúùûü")


def english_stem(w: str) -> str:
    from nrtsearch_tpu_torch.analysis.porter import porter_stem

    return porter_stem(w)


def french_stem(w: str) -> str:
    """Savoy-style French light stemmer: plural + feminine endings."""
    if len(w) > 5 and w.endswith("aux"):
        return w[:-3] + "al"
    if len(w) > 4 and w[-1] in "xs":
        w = w[:-1]
    if len(w) > 4 and w.endswith("r"):
        w = w[:-1]
    if len(w) > 4 and w.endswith("e"):
        w = w[:-1]
    if len(w) > 4 and w.endswith("é"):
        w = w[:-1]
    if len(w) > 4 and w[-1] == w[-2]:
        w = w[:-1]
    return w


def german_stem(w: str) -> str:
    """German light: strip plural/case endings + fold umlauts."""
    w = (
        w.replace("ä", "a").replace("ö", "o").replace("ü", "u").replace("ß", "ss")
    )
    for suf in ("ern", "em", "er", "en", "es", "e", "s", "n"):
        if len(w) - len(suf) >= 4 and w.endswith(suf):
            w = w[: -len(suf)]
            break
    return w


def spanish_stem(w: str) -> str:
    if len(w) < 5:
        return w
    for suf, repl in (
        ("eses", "es"), ("ces", "z"), ("os", "o"), ("as", "a"), ("es", "e"),
    ):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)] + repl
    if w[-1] in "soae" and len(w) >= 5:
        return w[:-1]
    return w


def italian_stem(w: str) -> str:
    if len(w) < 6:
        return w
    if w[-1] in "aeio":
        w = w[:-1]
    if len(w) >= 6 and w[-1] in "aeio":
        w = w[:-1]
    return w


def portuguese_stem(w: str) -> str:
    if len(w) < 4:
        return w
    for suf, repl in (
        ("ões", "ão"), ("ães", "ão"), ("res", "r"), ("ns", "m"),
        ("eis", "el"), ("ais", "al"), ("óis", "ol"), ("is", "il"),
    ):
        if w.endswith(suf) and len(w) - len(suf) >= 2:
            return w[: -len(suf)] + repl
    if w.endswith("s") and len(w) >= 4:
        return w[:-1]
    return w


def dutch_stem(w: str) -> str:
    for suf in ("heden",):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)] + "heid"
    for suf in ("ene", "en", "se", "s", "e"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            w = w[: -len(suf)]
            if len(w) >= 4 and w[-1] == w[-2] and w[-1] not in _VOWELS:
                w = w[:-1]  # dubbele medeklinker
            return w
    return w


def russian_stem(w: str) -> str:
    for suf in (
        "иями", "ями", "ами", "ией", "иям", "ием", "иях", "ев", "ов", "ие",
        "ые", "ых", "их", "ье", "еи", "ии", "ей", "ой", "ий", "ый", "ям",
        "ем", "ам", "ом", "ах", "ях", "ию", "ью", "ю", "ия", "ья", "я",
        "а", "е", "и", "й", "о", "у", "ы", "ь",
    ):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


def swedish_stem(w: str) -> str:
    for suf in ("erna", "arna", "orna", "erne", "ande", "arne", "aste", "en",
                "ar", "er", "or", "et", "na", "a", "e", "n", "s", "t"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


def norwegian_stem(w: str) -> str:
    for suf in ("ene", "ane", "ete", "en", "et", "er", "ar", "a", "e", "s"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


def danish_stem(w: str) -> str:
    for suf in ("erne", "ende", "erens", "ene", "ers", "ets", "eren", "er",
                "en", "et", "e", "s"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


def finnish_stem(w: str) -> str:
    """Finnish light: strip the most common case endings (partitive,
    inessive, elative, adessive, ablative, allative, plural markers)."""
    for suf in ("issa", "issä", "ista", "istä", "illa", "illä", "ilta",
                "iltä", "ille", "ssa", "ssä", "sta", "stä", "lla", "llä",
                "lta", "ltä", "lle", "ksi", "ita", "itä", "iin", "in",
                "an", "än", "en", "at", "ät", "a", "ä", "t", "n"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


# language key -> (Lucene-style predefined name, stemmer, elision?)
LANGUAGES: dict[str, tuple[str, object]] = {
    "en": ("en.English", english_stem),
    "fr": ("fr.French", french_stem),
    "de": ("de.German", german_stem),
    "es": ("es.Spanish", spanish_stem),
    "it": ("it.Italian", italian_stem),
    "pt": ("pt.Portuguese", portuguese_stem),
    "nl": ("nl.Dutch", dutch_stem),
    "ru": ("ru.Russian", russian_stem),
    "sv": ("sv.Swedish", swedish_stem),
    "da": ("da.Danish", danish_stem),
    "no": ("no.Norwegian", norwegian_stem),
    "fi": ("fi.Finnish", finnish_stem),
}

LANGUAGE_NAMES = {
    "en": "english", "fr": "french", "de": "german", "es": "spanish",
    "it": "italian", "pt": "portuguese", "nl": "dutch", "ru": "russian",
    "sv": "swedish", "da": "danish", "no": "norwegian", "fi": "finnish",
}
