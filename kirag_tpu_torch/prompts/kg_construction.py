"""Few-shot demonstrations for knowledge-triple extraction.

Original demonstration data (same SCHEMA as the reference's
`prompts/kg_construction/*_demonstrations.py` — records of
``{"title", "text", "triples"}`` — but independently authored documents).
Users can extend or replace these lists, or pass ``examplars=`` to
:class:`kirag_tpu_torch.kg.KGGenerator` to load their own.
"""

HOTPOTQA_EXAMPLARS = [
    {
        "title": "Edison Bridge",
        "text": "The Edison Bridge is a through arch bridge over the Raritan River in New "
                "Jersey. It was completed in 1931 and named after the inventor Thomas Edison, "
                "who maintained a laboratory in nearby Menlo Park.",
        "triples": "<Edison Bridge; is a; through arch bridge> <Edison Bridge; crosses; Raritan River> "
                   "<Edison Bridge; located in; New Jersey> <Edison Bridge; completed in; 1931> "
                   "<Edison Bridge; named after; Thomas Edison> <Thomas Edison; maintained a laboratory in; Menlo Park>",
    },
    {
        "title": "Mira Nair",
        "text": "Mira Nair is an Indian-American filmmaker born in Rourkela, Odisha. Her debut "
                "feature film Salaam Bombay! won the Camera d'Or at the 1988 Cannes Film Festival.",
        "triples": "<Mira Nair; is; Indian-American filmmaker> <Mira Nair; born in; Rourkela, Odisha> "
                   "<Salaam Bombay!; debut feature film of; Mira Nair> "
                   "<Salaam Bombay!; won; Camera d'Or> <Camera d'Or; awarded at; 1988 Cannes Film Festival>",
    },
    {
        "title": "Operation Paperclip",
        "text": "Operation Paperclip was a secret United States intelligence program that brought "
                "more than 1,600 German scientists to America after World War II. Wernher von Braun, "
                "who later led the development of the Saturn V rocket, was among them.",
        "triples": "<Operation Paperclip; was; secret United States intelligence program> "
                   "<Operation Paperclip; brought to America; more than 1,600 German scientists> "
                   "<Operation Paperclip; occurred after; World War II> "
                   "<Wernher von Braun; participant of; Operation Paperclip> "
                   "<Wernher von Braun; led the development of; Saturn V rocket>",
    },
    {
        "title": "Lake Baikal",
        "text": "Lake Baikal is a rift lake in southern Siberia, Russia. It is the deepest lake "
                "in the world, reaching 1,642 metres, and holds about one fifth of the world's "
                "unfrozen fresh water.",
        "triples": "<Lake Baikal; is a; rift lake> <Lake Baikal; located in; southern Siberia, Russia> "
                   "<Lake Baikal; is; deepest lake in the world> <Lake Baikal; depth; 1,642 metres> "
                   "<Lake Baikal; holds; one fifth of the world's unfrozen fresh water>",
    },
    {
        "title": "The Velvet Underground",
        "text": "The Velvet Underground was an American rock band formed in New York City in 1964. "
                "The band was managed by Andy Warhol, who also designed the cover of their debut "
                "album The Velvet Underground & Nico.",
        "triples": "<The Velvet Underground; was; American rock band> "
                   "<The Velvet Underground; formed in; New York City> "
                   "<The Velvet Underground; formed in; 1964> "
                   "<The Velvet Underground; managed by; Andy Warhol> "
                   "<Andy Warhol; designed the cover of; The Velvet Underground & Nico>",
    },
]

WIKIMULTIHOPQA_EXAMPLARS = [
    {
        "title": "Margaret of Anjou",
        "text": "Margaret of Anjou was Queen of England from 1445 to 1461 by marriage to King "
                "Henry VI. She was the daughter of Rene, King of Naples.",
        "triples": "<Margaret of Anjou; was; Queen of England> "
                   "<Margaret of Anjou; reign; 1445 to 1461> "
                   "<Margaret of Anjou; spouse; Henry VI> "
                   "<Margaret of Anjou; father; Rene, King of Naples>",
    },
    {
        "title": "A Trip to the Moon",
        "text": "A Trip to the Moon is a 1902 French science fiction film directed by Georges "
                "Melies. Melies died in Paris in 1938.",
        "triples": "<A Trip to the Moon; is a; 1902 French science fiction film> "
                   "<A Trip to the Moon; directed by; Georges Melies> "
                   "<Georges Melies; place of death; Paris> <Georges Melies; year of death; 1938>",
    },
    {
        "title": "Hans Zimmer",
        "text": "Hans Zimmer is a German film composer born in Frankfurt in 1957. He composed the "
                "score for the film Inception, directed by Christopher Nolan.",
        "triples": "<Hans Zimmer; is; German film composer> <Hans Zimmer; born in; Frankfurt> "
                   "<Hans Zimmer; year of birth; 1957> <Hans Zimmer; composed the score for; Inception> "
                   "<Inception; directed by; Christopher Nolan>",
    },
    {
        "title": "Tughlaqabad Fort",
        "text": "Tughlaqabad Fort is a ruined fort in Delhi, built by Ghiyas-ud-din Tughlaq, the "
                "founder of the Tughlaq dynasty, in 1321.",
        "triples": "<Tughlaqabad Fort; is a; ruined fort> <Tughlaqabad Fort; located in; Delhi> "
                   "<Tughlaqabad Fort; built by; Ghiyas-ud-din Tughlaq> "
                   "<Ghiyas-ud-din Tughlaq; founder of; Tughlaq dynasty> "
                   "<Tughlaqabad Fort; built in; 1321>",
    },
    {
        "title": "Clara Schumann",
        "text": "Clara Schumann was a German pianist and composer. She was married to the composer "
                "Robert Schumann, whom she met through her father Friedrich Wieck, her piano teacher.",
        "triples": "<Clara Schumann; was; German pianist and composer> "
                   "<Clara Schumann; spouse; Robert Schumann> "
                   "<Clara Schumann; father; Friedrich Wieck> "
                   "<Friedrich Wieck; was piano teacher of; Clara Schumann>",
    },
]

MUSIQUE_EXAMPLARS = [
    {
        "title": "Port of Rotterdam",
        "text": "The Port of Rotterdam is the largest seaport in Europe, located in the city of "
                "Rotterdam in the province of South Holland, Netherlands.",
        "triples": "<Port of Rotterdam; is; largest seaport in Europe> "
                   "<Port of Rotterdam; located in; Rotterdam> "
                   "<Rotterdam; located in province; South Holland> "
                   "<South Holland; country; Netherlands>",
    },
    {
        "title": "Kiri Te Kanawa",
        "text": "Kiri Te Kanawa is a New Zealand soprano. She performed at the 1981 wedding of "
                "Prince Charles and Lady Diana Spencer at St Paul's Cathedral in London.",
        "triples": "<Kiri Te Kanawa; is; New Zealand soprano> "
                   "<Kiri Te Kanawa; performed at; wedding of Prince Charles and Lady Diana Spencer> "
                   "<wedding of Prince Charles and Lady Diana Spencer; held at; St Paul's Cathedral> "
                   "<St Paul's Cathedral; located in; London> "
                   "<wedding of Prince Charles and Lady Diana Spencer; year; 1981>",
    },
    {
        "title": "Mount Kosciuszko",
        "text": "Mount Kosciuszko is the highest mountain in mainland Australia. It lies in the "
                "Snowy Mountains range within Kosciuszko National Park in New South Wales.",
        "triples": "<Mount Kosciuszko; is; highest mountain in mainland Australia> "
                   "<Mount Kosciuszko; part of range; Snowy Mountains> "
                   "<Mount Kosciuszko; within; Kosciuszko National Park> "
                   "<Kosciuszko National Park; located in; New South Wales>",
    },
    {
        "title": "Radiohead",
        "text": "Radiohead are an English rock band from Abingdon, Oxfordshire, formed in 1985. "
                "Their third album OK Computer was produced with Nigel Godrich.",
        "triples": "<Radiohead; are; English rock band> <Radiohead; from; Abingdon, Oxfordshire> "
                   "<Radiohead; formed in; 1985> <OK Computer; third album of; Radiohead> "
                   "<OK Computer; produced with; Nigel Godrich>",
    },
]

WIKIPEDIA_EXAMPLARS = [
    {
        "title": "Photosynthesis",
        "text": "Photosynthesis is the process by which green plants convert light energy into "
                "chemical energy. It takes place in chloroplasts and produces oxygen as a byproduct.",
        "triples": "<Photosynthesis; is; process converting light energy into chemical energy> "
                   "<Photosynthesis; performed by; green plants> "
                   "<Photosynthesis; takes place in; chloroplasts> "
                   "<Photosynthesis; produces as byproduct; oxygen>",
    },
    {
        "title": "Alan Turing",
        "text": "Alan Turing was an English mathematician and computer scientist born in London "
                "in 1912. He worked at Bletchley Park during World War II and formulated the "
                "concept of the Turing machine.",
        "triples": "<Alan Turing; was; English mathematician and computer scientist> "
                   "<Alan Turing; born in; London> <Alan Turing; year of birth; 1912> "
                   "<Alan Turing; worked at; Bletchley Park> "
                   "<Alan Turing; formulated; Turing machine>",
    },
    {
        "title": "Danube",
        "text": "The Danube is Europe's second-longest river. It originates in the Black Forest "
                "in Germany and flows into the Black Sea through the Danube Delta.",
        "triples": "<Danube; is; Europe's second-longest river> "
                   "<Danube; originates in; Black Forest> <Black Forest; located in; Germany> "
                   "<Danube; flows into; Black Sea> <Danube; mouth; Danube Delta>",
    },
    {
        "title": "Penicillin",
        "text": "Penicillin is a group of antibiotics derived from Penicillium moulds. It was "
                "discovered by Alexander Fleming in 1928 at St Mary's Hospital in London.",
        "triples": "<Penicillin; is; group of antibiotics> "
                   "<Penicillin; derived from; Penicillium moulds> "
                   "<Penicillin; discovered by; Alexander Fleming> "
                   "<Penicillin; discovered in; 1928> "
                   "<Alexander Fleming; worked at; St Mary's Hospital, London>",
    },
]

HOTPOTQA_EXAMPLARS += [
    {
        "title": "Golden Gate Bridge",
        "text": "The Golden Gate Bridge is a suspension bridge spanning the Golden Gate "
                "strait between San Francisco and Marin County. Its chief engineer was "
                "Joseph Strauss, and it opened to traffic in 1937.",
        "triples": "<Golden Gate Bridge; is a; suspension bridge> "
                   "<Golden Gate Bridge; spans; Golden Gate strait> "
                   "<Golden Gate Bridge; connects; San Francisco and Marin County> "
                   "<Golden Gate Bridge; chief engineer; Joseph Strauss> "
                   "<Golden Gate Bridge; opened in; 1937>",
    },
    {
        "title": "Toni Morrison",
        "text": "Toni Morrison was an American novelist who won the Nobel Prize in "
                "Literature in 1993. Her novel Beloved won the Pulitzer Prize for "
                "Fiction and was adapted into a 1998 film starring Oprah Winfrey.",
        "triples": "<Toni Morrison; was; American novelist> "
                   "<Toni Morrison; won; Nobel Prize in Literature> "
                   "<Toni Morrison; Nobel Prize year; 1993> "
                   "<Beloved; written by; Toni Morrison> "
                   "<Beloved; won; Pulitzer Prize for Fiction> "
                   "<Beloved; adapted into film in; 1998> "
                   "<Beloved (1998 film); starring; Oprah Winfrey>",
    },
    {
        "title": "CERN",
        "text": "CERN is a European research organization that operates the Large Hadron "
                "Collider, the world's largest particle accelerator, near Geneva on the "
                "France-Switzerland border. The World Wide Web was invented at CERN by "
                "Tim Berners-Lee in 1989.",
        "triples": "<CERN; is; European research organization> "
                   "<CERN; operates; Large Hadron Collider> "
                   "<Large Hadron Collider; is; world's largest particle accelerator> "
                   "<CERN; located near; Geneva> "
                   "<World Wide Web; invented at; CERN> "
                   "<World Wide Web; invented by; Tim Berners-Lee> "
                   "<World Wide Web; invented in; 1989>",
    },
]

WIKIMULTIHOPQA_EXAMPLARS += [
    {
        "title": "Ada Lovelace",
        "text": "Ada Lovelace was an English mathematician, the daughter of the poet "
                "Lord Byron. She worked with Charles Babbage on the Analytical Engine.",
        "triples": "<Ada Lovelace; was; English mathematician> "
                   "<Ada Lovelace; father; Lord Byron> <Lord Byron; was; poet> "
                   "<Ada Lovelace; worked with; Charles Babbage> "
                   "<Charles Babbage; designed; Analytical Engine>",
    },
    {
        "title": "Spirited Away",
        "text": "Spirited Away is a 2001 animated film directed by Hayao Miyazaki and "
                "produced by Studio Ghibli. It won the Academy Award for Best Animated "
                "Feature in 2003.",
        "triples": "<Spirited Away; is a; 2001 animated film> "
                   "<Spirited Away; directed by; Hayao Miyazaki> "
                   "<Spirited Away; produced by; Studio Ghibli> "
                   "<Spirited Away; won; Academy Award for Best Animated Feature> "
                   "<Spirited Away; Academy Award year; 2003>",
    },
    {
        "title": "Suez Canal",
        "text": "The Suez Canal is an artificial waterway in Egypt connecting the "
                "Mediterranean Sea to the Red Sea. It was opened in 1869 under the "
                "direction of Ferdinand de Lesseps.",
        "triples": "<Suez Canal; is; artificial waterway> <Suez Canal; located in; Egypt> "
                   "<Suez Canal; connects; Mediterranean Sea and Red Sea> "
                   "<Suez Canal; opened in; 1869> "
                   "<Suez Canal; directed by; Ferdinand de Lesseps>",
    },
]

MUSIQUE_EXAMPLARS += [
    {
        "title": "Machu Picchu",
        "text": "Machu Picchu is a 15th-century Inca citadel in the Cusco Region of "
                "Peru, situated above the Sacred Valley. It was brought to international "
                "attention by Hiram Bingham in 1911.",
        "triples": "<Machu Picchu; is; 15th-century Inca citadel> "
                   "<Machu Picchu; located in; Cusco Region> <Cusco Region; country; Peru> "
                   "<Machu Picchu; situated above; Sacred Valley> "
                   "<Machu Picchu; publicized by; Hiram Bingham> "
                   "<Machu Picchu; publicized in; 1911>",
    },
    {
        "title": "BBC",
        "text": "The British Broadcasting Corporation is headquartered at Broadcasting "
                "House in the City of Westminster, London. It was founded in 1922 and "
                "its first director-general was John Reith.",
        "triples": "<British Broadcasting Corporation; headquartered at; Broadcasting House> "
                   "<Broadcasting House; located in; City of Westminster> "
                   "<City of Westminster; part of; London> "
                   "<British Broadcasting Corporation; founded in; 1922> "
                   "<British Broadcasting Corporation; first director-general; John Reith>",
    },
]

# ---------------------------------------------------------------------------
# Round-2 bank extension: documents backing the enlarged reasoning-chain /
# selection banks in kg_selection.py (the reference ships ~8-10 documents per
# dataset in `prompts/kg_construction/*_demonstrations.py`; these bring each
# bank to reference scale with original text).
# ---------------------------------------------------------------------------

HOTPOTQA_EXAMPLARS += [
    {
        "title": "Eiffel Tower",
        "text": "The Eiffel Tower is a wrought-iron lattice tower in Paris designed by "
                "Gustave Eiffel's engineering company. Completed in 1889, it served as the "
                "entrance arch to the 1889 World's Fair.",
        "triples": "<Eiffel Tower; is; wrought-iron lattice tower> "
                   "<Eiffel Tower; located in; Paris> "
                   "<Eiffel Tower; designed by; Gustave Eiffel> "
                   "<Eiffel Tower; completed in; 1889> "
                   "<Eiffel Tower; served as; entrance arch to the 1889 World's Fair>",
    },
    {
        "title": "Kon-Tiki",
        "text": "Kon-Tiki was the balsa-wood raft used by the Norwegian explorer Thor "
                "Heyerdahl to cross the Pacific Ocean in 1947. The raft is displayed at the "
                "Kon-Tiki Museum in Oslo.",
        "triples": "<Kon-Tiki; was; balsa-wood raft> <Kon-Tiki; raft of; Thor Heyerdahl> "
                   "<Thor Heyerdahl; was; Norwegian explorer> "
                   "<Kon-Tiki; crossed the Pacific in; 1947> "
                   "<Kon-Tiki; displayed at; Kon-Tiki Museum> "
                   "<Kon-Tiki Museum; located in; Oslo>",
    },
    {
        "title": "Marie Curie",
        "text": "Marie Curie was a physicist and chemist born in Warsaw in 1867. She was "
                "the first person to win two Nobel Prizes, and together with her husband "
                "Pierre Curie she discovered the elements polonium and radium.",
        "triples": "<Marie Curie; was; physicist and chemist> "
                   "<Marie Curie; born in; Warsaw> <Marie Curie; year of birth; 1867> "
                   "<Marie Curie; was; first person to win two Nobel Prizes> "
                   "<Marie Curie; spouse; Pierre Curie> "
                   "<Marie Curie and Pierre Curie; discovered; polonium> "
                   "<Marie Curie and Pierre Curie; discovered; radium>",
    },
    {
        "title": "Neil Armstrong",
        "text": "Neil Armstrong was an American astronaut born in Wapakoneta, Ohio. As "
                "commander of Apollo 11 in 1969, he became the first person to walk on "
                "the Moon.",
        "triples": "<Neil Armstrong; was; American astronaut> "
                   "<Neil Armstrong; born in; Wapakoneta, Ohio> "
                   "<Neil Armstrong; commander of; Apollo 11> "
                   "<Apollo 11; first Moon landing mission; 1969> "
                   "<Neil Armstrong; first person to walk on; the Moon>",
    },
    {
        "title": "Taj Mahal",
        "text": "The Taj Mahal is an ivory-white marble mausoleum in Agra, India. It was "
                "commissioned by the Mughal emperor Shah Jahan in memory of his wife "
                "Mumtaz Mahal.",
        "triples": "<Taj Mahal; is; ivory-white marble mausoleum> "
                   "<Taj Mahal; located in; Agra> <Agra; country; India> "
                   "<Taj Mahal; commissioned by; Shah Jahan> "
                   "<Shah Jahan; was; Mughal emperor> "
                   "<Taj Mahal; built in memory of; Mumtaz Mahal>",
    },
    {
        "title": "Arthur Conan Doyle",
        "text": "Arthur Conan Doyle was a British writer who created the detective "
                "Sherlock Holmes. He studied medicine in Edinburgh, where his teacher "
                "Joseph Bell inspired the detective's methods.",
        "triples": "<Arthur Conan Doyle; was; British writer> "
                   "<Sherlock Holmes; created by; Arthur Conan Doyle> "
                   "<Arthur Conan Doyle; studied medicine in; Edinburgh> "
                   "<Joseph Bell; teacher of; Arthur Conan Doyle> "
                   "<Joseph Bell; inspired; Sherlock Holmes>",
    },
]

WIKIMULTIHOPQA_EXAMPLARS += [
    {
        "title": "Akira Kurosawa",
        "text": "Akira Kurosawa was a Japanese film director born in Tokyo in 1910. His "
                "1954 film Seven Samurai is often ranked among the greatest films ever made.",
        "triples": "<Akira Kurosawa; was; Japanese film director> "
                   "<Akira Kurosawa; place of birth; Tokyo> "
                   "<Akira Kurosawa; year of birth; 1910> "
                   "<Seven Samurai; directed by; Akira Kurosawa> "
                   "<Seven Samurai; released in; 1954>",
    },
    {
        "title": "Wolfgang Amadeus Mozart",
        "text": "Wolfgang Amadeus Mozart was a composer born in Salzburg in 1756. He "
                "composed the opera The Magic Flute and died in Vienna in 1791.",
        "triples": "<Wolfgang Amadeus Mozart; was; composer> "
                   "<Wolfgang Amadeus Mozart; place of birth; Salzburg> "
                   "<Wolfgang Amadeus Mozart; year of birth; 1756> "
                   "<The Magic Flute; composed by; Wolfgang Amadeus Mozart> "
                   "<Wolfgang Amadeus Mozart; place of death; Vienna> "
                   "<Wolfgang Amadeus Mozart; year of death; 1791>",
    },
    {
        "title": "Leo Tolstoy",
        "text": "Leo Tolstoy was a Russian writer, the author of War and Peace and Anna "
                "Karenina. He died at the railway station of Astapovo in 1910.",
        "triples": "<Leo Tolstoy; was; Russian writer> "
                   "<War and Peace; written by; Leo Tolstoy> "
                   "<Anna Karenina; written by; Leo Tolstoy> "
                   "<Leo Tolstoy; place of death; Astapovo> "
                   "<Leo Tolstoy; year of death; 1910>",
    },
    {
        "title": "Queen Victoria",
        "text": "Queen Victoria reigned over the United Kingdom from 1837 until 1901. Her "
                "father was Prince Edward, Duke of Kent, a son of King George III.",
        "triples": "<Queen Victoria; reigned from; 1837> "
                   "<Queen Victoria; reigned until; 1901> "
                   "<Queen Victoria; father; Prince Edward, Duke of Kent> "
                   "<Prince Edward, Duke of Kent; father; George III>",
    },
    {
        "title": "Frida Kahlo",
        "text": "Frida Kahlo was a Mexican painter born in Coyoacan. She was married to "
                "the muralist Diego Rivera, who was born in 1886.",
        "triples": "<Frida Kahlo; was; Mexican painter> "
                   "<Frida Kahlo; born in; Coyoacan> "
                   "<Frida Kahlo; spouse; Diego Rivera> "
                   "<Diego Rivera; was; muralist> "
                   "<Diego Rivera; year of birth; 1886>",
    },
    {
        "title": "J. R. R. Tolkien",
        "text": "J. R. R. Tolkien was an English writer and philologist who wrote The "
                "Hobbit and The Lord of the Rings. He taught at the University of Oxford.",
        "triples": "<J. R. R. Tolkien; was; English writer and philologist> "
                   "<The Hobbit; written by; J. R. R. Tolkien> "
                   "<The Lord of the Rings; written by; J. R. R. Tolkien> "
                   "<J. R. R. Tolkien; taught at; University of Oxford>",
    },
]

MUSIQUE_EXAMPLARS += [
    {
        "title": "Boeing",
        "text": "Boeing is an American aerospace company founded by William Boeing in "
                "1916. It manufactures the 747 wide-body airliner at its Everett factory "
                "in Washington state.",
        "triples": "<Boeing; is; American aerospace company> "
                   "<Boeing; founded by; William Boeing> <Boeing; founded in; 1916> "
                   "<747; manufactured by; Boeing> "
                   "<747; built at; Everett factory> "
                   "<Everett factory; located in; Washington state>",
    },
    {
        "title": "Nile",
        "text": "The Nile is a major river of northeastern Africa that flows through "
                "Cairo, the capital of Egypt, and empties into the Mediterranean Sea "
                "through a large delta.",
        "triples": "<Nile; is; major river of northeastern Africa> "
                   "<Cairo; lies on; Nile> <Cairo; capital of; Egypt> "
                   "<Nile; empties into; Mediterranean Sea> "
                   "<Nile; forms; large delta>",
    },
    {
        "title": "Colosseum",
        "text": "The Colosseum is an ancient amphitheatre in the centre of Rome, the "
                "capital of Italy. Italy adopted the euro as its currency in 1999.",
        "triples": "<Colosseum; is; ancient amphitheatre> "
                   "<Colosseum; located in; Rome> <Rome; capital of; Italy> "
                   "<Rome; country; Italy> <Italy; currency; euro> "
                   "<Italy; adopted the euro in; 1999>",
    },
    {
        "title": "Blade Runner",
        "text": "Blade Runner is a 1982 science fiction film directed by Ridley Scott. "
                "It is based on the novel Do Androids Dream of Electric Sheep? by "
                "Philip K. Dick.",
        "triples": "<Blade Runner; is a; 1982 science fiction film> "
                   "<Blade Runner; directed by; Ridley Scott> "
                   "<Blade Runner; based on; Do Androids Dream of Electric Sheep?> "
                   "<Do Androids Dream of Electric Sheep?; written by; Philip K. Dick>",
    },
    {
        "title": "Mustafa Kemal Ataturk",
        "text": "Mustafa Kemal Ataturk was the first president of Turkey, whose largest "
                "city is Istanbul. After his death in 1938 he was succeeded by Ismet Inonu.",
        "triples": "<Mustafa Kemal Ataturk; first president of; Turkey> "
                   "<Istanbul; largest city of; Turkey> "
                   "<Mustafa Kemal Ataturk; died in; 1938> "
                   "<Mustafa Kemal Ataturk; succeeded by; Ismet Inonu>",
    },
    {
        "title": "Sistine Chapel",
        "text": "The Sistine Chapel is a chapel in Vatican City named after Pope Sixtus "
                "IV, who restored it in the 15th century. Its ceiling was painted by "
                "Michelangelo between 1508 and 1512.",
        "triples": "<Sistine Chapel; located in; Vatican City> "
                   "<Sistine Chapel; named after; Pope Sixtus IV> "
                   "<Pope Sixtus IV; restored; Sistine Chapel> "
                   "<Sistine Chapel ceiling; painted by; Michelangelo> "
                   "<Sistine Chapel ceiling; painted between; 1508 and 1512>",
    },
]

WIKIPEDIA_EXAMPLARS += [
    {
        "title": "DNA",
        "text": "DNA is the molecule that carries genetic information in living "
                "organisms. Its double-helix structure was described in 1953 by James "
                "Watson and Francis Crick, drawing on X-ray data from Rosalind Franklin.",
        "triples": "<DNA; carries; genetic information> "
                   "<DNA; structure; double helix> "
                   "<DNA double helix; described by; James Watson and Francis Crick> "
                   "<DNA double helix; described in; 1953> "
                   "<Rosalind Franklin; provided X-ray data for; DNA double helix>",
    },
    {
        "title": "Printing press",
        "text": "The movable-type printing press was introduced to Europe by Johannes "
                "Gutenberg around 1440 in Mainz. His forty-two-line Bible was among the "
                "first major books printed with it.",
        "triples": "<printing press; introduced to Europe by; Johannes Gutenberg> "
                   "<printing press; introduced around; 1440> "
                   "<Johannes Gutenberg; worked in; Mainz> "
                   "<Gutenberg Bible; printed by; Johannes Gutenberg> "
                   "<Gutenberg Bible; also called; forty-two-line Bible>",
    },
    {
        "title": "Amazon rainforest",
        "text": "The Amazon rainforest is the largest tropical rainforest on Earth, "
                "spanning nine countries in South America. About sixty percent of it "
                "lies within Brazil.",
        "triples": "<Amazon rainforest; is; largest tropical rainforest on Earth> "
                   "<Amazon rainforest; spans; nine countries> "
                   "<Amazon rainforest; located in; South America> "
                   "<Amazon rainforest; sixty percent within; Brazil>",
    },
    {
        "title": "General relativity",
        "text": "General relativity is a theory of gravitation published by Albert "
                "Einstein in 1915. It was famously confirmed by Arthur Eddington's "
                "observations of the 1919 solar eclipse.",
        "triples": "<general relativity; is; theory of gravitation> "
                   "<general relativity; published by; Albert Einstein> "
                   "<general relativity; published in; 1915> "
                   "<general relativity; confirmed by; Arthur Eddington> "
                   "<Arthur Eddington; observed; 1919 solar eclipse>",
    },
]

WIKIPEDIA_EXAMPLARS += [
    {
        "title": "Haber process",
        "text": "The Haber process produces ammonia from nitrogen and hydrogen using an "
                "iron catalyst. It was developed by Fritz Haber and scaled industrially "
                "by Carl Bosch at BASF.",
        "triples": "<Haber process; produces; ammonia> "
                   "<Haber process; inputs; nitrogen and hydrogen> "
                   "<Haber process; uses catalyst; iron> "
                   "<Haber process; developed by; Fritz Haber> "
                   "<Haber process; industrialized by; Carl Bosch> "
                   "<Carl Bosch; worked at; BASF>",
    },
    {
        "title": "Great Barrier Reef",
        "text": "The Great Barrier Reef is the world's largest coral reef system, "
                "located in the Coral Sea off the coast of Queensland, Australia. It was "
                "designated a World Heritage Site in 1981.",
        "triples": "<Great Barrier Reef; is; world's largest coral reef system> "
                   "<Great Barrier Reef; located in; Coral Sea> "
                   "<Great Barrier Reef; off the coast of; Queensland, Australia> "
                   "<Great Barrier Reef; designated World Heritage Site in; 1981>",
    },
]
